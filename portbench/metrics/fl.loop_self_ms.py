"""fl.loop_self_ms: the round loop's own time, a round (host clock, from
its start to the next round's) less every top-level span of
``FLResult.phase_s`` (the keys without ``_``: key, sample, link,
downlink, gradients, uplink, telemetry, apply, eval), mean milliseconds a
round over the window's rounds. A program whose rounds report no
``sample`` span gives nothing."""


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any("sample" not in r["phase_s"] for r in rounds):
        return None
    rest = [r["dur_s"] - sum(v for k, v in r["phase_s"].items()
                             if "_" not in k) for r in rounds]
    return 1e3 * sum(rest) / len(rest)
