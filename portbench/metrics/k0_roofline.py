"""k0_roofline: K0 (``csrc/approx_channel.cu::k0_approx_channel_row``) as a
share of its least time on the step's padded row (operations at the
float32 rate bind it; ``portbench/core/roofline.py::kernel_bound``), over
its mean device time in the profiled stretch, in percent."""

KERNEL = "k0_approx_channel_row"


def read(rec):
    from portbench.core.trace import kernel_ms

    bound = rec.get("k0_bound_ms")
    ms = kernel_ms(rec.get("profile"), KERNEL)
    if bound is None or not ms:
        return None
    return 100.0 * bound / ms
