"""fl.sample_ms: the numpy minibatch gather and its copy to the device, the
span ``sample``, ``FLResult.phase_s["sample"]``, mean milliseconds a round
over the window's rounds. A program whose rounds do not report it gives
nothing."""

KEY = "sample"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
