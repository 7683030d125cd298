"""model: the served forward's share of the card's peak over its own
device time: a slice's operations over the peak of their precision
(``reference/counts.py``) over the card's time a served slice
(``card_ms_per_slice``, CUDA events around each forward).  Moves
``card_ms_per_slice`` and bounds every kernel's gain in it."""

MOVES = "card_ms_per_slice"


def read(ctx):
    if not ctx.card_ms_per_slice:
        return None
    return 100.0 * ctx.slice_ideal_s / (ctx.card_ms_per_slice / 1e3)
