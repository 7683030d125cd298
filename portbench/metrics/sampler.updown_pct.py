"""sampler: the share of the sampler's card time that ADM's resampling
ResBlocks take (the five down- and five up-ResBlocks: each one's norms,
the pool or repeat of h and x, its two convs and the residual): the
device time of the port's ``ddpm.updown`` spans over that of the
``sampler.step`` span around them, the median over the steps recorded
whole in the profiled sub-window (CUDA events on the engine's stream,
``program_spans``).  Moves ``served_slices_per_s``.  None where the port
records no such spans."""

from portbench.program_spans import device_share

MOVES = "served_slices_per_s"


def read(ctx):
    return device_share(ctx, "sampler.step", ("ddpm.updown",))
