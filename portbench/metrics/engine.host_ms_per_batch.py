"""engine: the dispatcher's host milliseconds a batch outside its wait
for the card: assembly (``EngineStats.assemble_time_s``: the drain, the
row copies, the padding), the dispatch (``dispatch_s``: the upload, the
forward's launches and the copy back, enqueued), the copy out of the
pinned buffer (``copy_out_s``) and the futures (``resolve_s``), over the
batches; the engine's own counters over the stretch of the window before
the profiler starts.  Its ``moves`` is the cell's end-to-end metric
``card_ms_per_slice``, which it does not move: it explains the host pace
behind ``engine.slices_per_s`` and the card's idle share, against the
card's time a batch.  None from an engine without these counters."""

MOVES = "card_ms_per_slice"
PARTS = ("assemble_time_s", "dispatch_s", "copy_out_s", "resolve_s")


def read(ctx):
    e = ctx.engine
    if e.get("batches", 0) <= 0 or any(k not in e for k in PARTS):
        return None
    return 1e3 * sum(e[k] for k in PARTS) / e["batches"]
