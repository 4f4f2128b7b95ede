"""device.idle_pct: the share of the profiled stretch in which no device
operation ran, ``1 - busy_s / window_s`` of the device trace, in percent."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
