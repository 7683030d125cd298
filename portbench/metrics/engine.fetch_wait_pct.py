"""engine: the share of the engine's batch time spent waiting for the
device's result (``EngineStats.fetch_time_s`` over ``total_batch_time_s``,
both counted over the window; in the traced run, over its stretch before
the profiler starts).  Moves ``served_slices_per_s``: a high
share means the engine waits on the card, a low one that the host loop
holds it back."""

MOVES = "served_slices_per_s"


def read(ctx):
    total = ctx.engine.get("total_batch_time_s", 0.0)
    if total <= 0:
        return None
    return 100.0 * ctx.engine["fetch_time_s"] / total
