"""kernels: kernel B's share of its roofline in the Fast-DDPM sampler
(its float mode), counted as ``kernel_a_roofline`` is.  Moves
``served_slices_per_s``."""

from portbench.core import reader

MOVES = "served_slices_per_s"
PATTERN = reader("kernel_b_roofline").PATTERN


def read(ctx):
    return ctx.roofline("kernel_b", PATTERN)
