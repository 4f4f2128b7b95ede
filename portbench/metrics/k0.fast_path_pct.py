"""k0.fast_path_pct: the share of K0's symbols that its settling test
decides from their two magnitude draws (``csrc/approx_channel.cu::
settled``), so that only the rest run the full chain: 100 * (1 -
k0_symbols_slow / k0_symbols), both counters summed over the window's
steps (``records.steps[].counters``, set by ``kernels/approx_channel.py::
approx_channel_kernel``), in percent. A program without the counters
gives nothing."""


def read(rec):
    steps = rec.get("steps")
    if not steps or any(
            not {"k0_symbols", "k0_symbols_slow"} <= set(s.get("counters", {}))
            for s in steps):
        return None
    total = sum(sum(s["counters"]["k0_symbols"]) for s in steps)
    slow = sum(sum(s["counters"]["k0_symbols_slow"]) for s in steps)
    return 100.0 * (1.0 - slow / total) if total > 0 else None
