"""fl.gradients_ms: the clients' gradients (``FedSGD.payload`` over
``fl/cnn.py``), ``FLResult.phase_s["gradients"]``, mean milliseconds a
round over the window's rounds."""


def read(rec):
    rounds = rec.get("rounds")
    if not rounds:
        return None
    return 1e3 * sum(r["phase_s"]["gradients"] for r in rounds) / len(rounds)
