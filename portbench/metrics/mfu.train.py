"""model: the training step's share of the card's bf16 peak: the forward
and backward FLOPs of a step, counted on the plain reference with
``torch.utils.flop_counter``, a slice, times the triplets a second of the
window's unprofiled epochs, over 989 TFLOP/s.  Moves
``train_slices_per_s``."""

MOVES = "train_slices_per_s"


def read(ctx):
    if ctx.traffic.get("loop") != "train" or not ctx.rate:
        return None
    return 100.0 * ctx.rate * ctx.slice_ideal_s
