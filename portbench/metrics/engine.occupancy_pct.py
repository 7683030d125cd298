"""engine: the share of the dispatched batches' slots that held requests
and not wrap-padding (``EngineStats`` requests over requests plus padded
slots, over the window; in the traced run, over its stretch before the
profiler starts).  Moves ``volume_p95_ms``: under bursts the
engine dispatches part-full batches, and each padded slot is card time a
volume waits behind."""

MOVES = "volume_p95_ms"


def read(ctx):
    slots = ctx.engine.get("requests", 0) + ctx.engine.get("padded_slots", 0)
    if slots <= 0:
        return None
    return 100.0 * ctx.engine["requests"] / slots
