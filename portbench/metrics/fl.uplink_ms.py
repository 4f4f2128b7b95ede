"""fl.uplink_ms: the uplink (``core/transport.py`` -> ``kernels/ops.py``,
or the layered PHY, and the PS mean), ``FLResult.phase_s["uplink"]``, mean
milliseconds a round over the window's rounds."""


def read(rec):
    rounds = rec.get("rounds")
    if not rounds:
        return None
    return 1e3 * sum(r["phase_s"]["uplink"] for r in rounds) / len(rounds)
