"""loader: the share of the window the trainer spent waiting for the
train loader's next batch (the benchmark's span around each ``next``).
Moves ``train_slices_per_s``: the prefetch thread shares the host with the
step's launches."""

MOVES = "train_slices_per_s"


def read(ctx):
    if ctx.traffic.get("loop") != "train":
        return None
    t0, t1 = ctx.window
    spans = ctx.spans.within("loader.next", t0, t1 + 3600.0)
    if not spans:
        return None
    end = max(b for _, b in spans)
    return 100.0 * sum(b - a for a, b in spans) / (end - t0)
