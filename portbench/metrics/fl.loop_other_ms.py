"""fl.loop_other_ms: the round loop outside the gradients and the uplink
(``RoundEngine.run``: sampling, apply, telemetry, eval), a round's time
less its ``gradients`` and ``uplink`` phases, mean milliseconds a round
over the window's rounds."""


def read(rec):
    rounds = rec.get("rounds")
    if not rounds:
        return None
    rest = [r["dur_s"] - r["phase_s"]["gradients"] - r["phase_s"]["uplink"]
            for r in rounds]
    return 1e3 * sum(rest) / len(rest)
