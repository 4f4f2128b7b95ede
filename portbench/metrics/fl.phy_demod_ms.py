"""fl.phy_demod_ms: the layered PHY's demod (per-axis ML decisions and the
deinterleave), the device time of the span ``demod`` under ``uplink``,
``FLResult.phase_s["uplink_demod"]``, mean milliseconds a round over the
window's rounds. A program whose rounds do not report it gives nothing."""

KEY = "uplink_demod"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
