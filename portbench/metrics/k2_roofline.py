"""k2_roofline: K2 (``csrc/approx_channel.cu::k2_approx_channel_aggregate``)
as a share of its least time at the round's own shape (operations at the
float32 rate bind it; ``portbench/core/roofline.py::kernel_bound``), over
its mean device time in the profiled stretch, in percent."""

KERNEL = "k2_approx_channel_aggregate"


def read(rec):
    from portbench.core.trace import kernel_ms

    bound = rec.get("k2_bound_ms")
    ms = kernel_ms(rec.get("profile"), KERNEL)
    if bound is None or not ms:
        return None
    return 100.0 * bound / ms
