"""step: host milliseconds of one call into the trainer's step
(``SupervisedTrainer._train``: forward, loss, backward and Adam
enqueued), the mean over the window's steps, from the benchmark's span
around each call.  Moves ``train_slices_per_s``: where it exceeds the
step's device time, the host's launches hold the card back."""

MOVES = "train_slices_per_s"


def read(ctx):
    if ctx.traffic.get("loop") != "train":
        return None
    t0, t1 = ctx.window
    d = [b - a for a, b in ctx.spans.within("step", t0, t1 + 3600.0)]
    return 1e3 * sum(d) / len(d) if d else None
