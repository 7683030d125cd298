"""kernels: kernel A's share of its roofline in the Fast-DDPM sampler,
whose sites run its float epilogue, counted as ``kernel_a_roofline`` is.
Moves ``served_slices_per_s``."""

from portbench.core import reader

MOVES = "served_slices_per_s"
PATTERN = reader("kernel_a_roofline").PATTERN


def read(ctx):
    return ctx.roofline("kernel_a", PATTERN)
