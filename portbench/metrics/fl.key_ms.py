"""fl.key_ms: the round key's split off the run's key (threefry on the
host), the span ``key``, ``FLResult.phase_s["key"]``, mean milliseconds a
round over the window's rounds. A program whose rounds do not report it
gives nothing."""

KEY = "key"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
