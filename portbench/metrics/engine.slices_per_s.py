"""engine: the slices resolved to the clients a second, over the stretch
of the window that the profiler left alone, as ``served_slices_per_s``
counts them (batch completions for edges).  The host's pace between
processes sets it, so in a cell where it spreads too widely for a bound it
stands here, per layer.  Its ``moves`` is the cell's end-to-end metric
``card_ms_per_slice``, which it does not move: a gain in the engine's
host loop shows here alone."""

MOVES = "card_ms_per_slice"


def read(ctx):
    if ctx.traffic.get("loop") != "closed":
        return None
    return ctx.rate
