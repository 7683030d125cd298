"""engine: the share of the engine's batch time spent in
``synchronize`` on the batch's event, the wait for the card alone
(``EngineStats.sync_wait_s`` over ``total_batch_time_s``; the engine's
own counters over the stretch of the window before the profiler starts).
Low means the host sets the pace.  Its ``moves`` is the cell's
end-to-end metric ``card_ms_per_slice``, which it does not move: it
explains the host pace behind ``engine.slices_per_s`` and the card's
idle share.  None from an engine without the counter."""

MOVES = "card_ms_per_slice"


def read(ctx):
    total = ctx.engine.get("total_batch_time_s", 0.0)
    if total <= 0 or "sync_wait_s" not in ctx.engine:
        return None
    return 100.0 * ctx.engine["sync_wait_s"] / total
