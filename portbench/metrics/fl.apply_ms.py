"""fl.apply_ms: the PS update (``FedSGD.apply``: SGD), the span ``apply``,
``FLResult.phase_s["apply"]``, mean milliseconds a round over the window's
rounds. A program whose rounds do not report it gives nothing."""

KEY = "apply"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
