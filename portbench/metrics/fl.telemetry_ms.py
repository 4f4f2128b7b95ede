"""fl.telemetry_ms: the round's airtime, record, ledger line and sketches,
the span ``telemetry``, ``FLResult.phase_s["telemetry"]``, mean
milliseconds a round over the window's rounds. A program whose rounds do
not report it gives nothing."""

KEY = "telemetry"


def read(rec):
    rounds = rec.get("rounds")
    if not rounds or any(KEY not in r["phase_s"] for r in rounds):
        return None
    return 1e3 * sum(r["phase_s"][KEY] for r in rounds) / len(rounds)
