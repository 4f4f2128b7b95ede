"""fl.phy_codec_ms: the layered PHY's codec (words to bits and symbols and
the interleave; symbols back to words, the clamp, the error popcount and
the floats), the device time of the span ``codec`` under ``uplink``,
``FLResult.phase_s["uplink_codec"]``, mean milliseconds a round over the
window's rounds. A program whose rounds do not report it gives nothing."""

KEY = "uplink_codec"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
