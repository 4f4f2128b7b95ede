"""fl.eval_ms: the test-set accuracy, the span ``eval``,
``FLResult.phase_s["eval"]`` (0 on rounds without one), mean milliseconds
a round over all the window's rounds. A program whose rounds do not report
it gives nothing."""

KEY = "eval"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
