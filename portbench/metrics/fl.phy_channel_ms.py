"""fl.phy_channel_ms: the layered PHY's channel (Gray QAM, the threefry
fading and noise draws, zero-forcing), the device time of the span
``channel`` under ``uplink``, ``FLResult.phase_s["uplink_channel"]``, mean
milliseconds a round over the window's rounds. A program whose rounds do
not report it gives nothing."""

KEY = "uplink_channel"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
