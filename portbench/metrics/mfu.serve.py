"""model: the served model's share of the card's peak: each served
slice's operations over the peak of their precision (int8 sites at 1,979
TOP/s, the rest at 989 TFLOP/s bf16; ``reference/counts.py``), times the
slices resolved a second in the window.  Moves ``served_slices_per_s``
and bounds every kernel's gain."""

MOVES = "served_slices_per_s"


def read(ctx):
    if ctx.rate is None or ctx.traffic.get("loop") != "closed":
        return None
    return 100.0 * ctx.rate * ctx.slice_ideal_s
