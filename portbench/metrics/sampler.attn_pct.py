"""sampler: the share of the sampler's card time that the DDPM UNet's
attention blocks take: the device time of the port's ``ddpm.attn`` spans
over that of the ``sampler.step`` span around them, the median over the
steps recorded whole in the profiled sub-window (CUDA events on the
engine's stream, ``program_spans``).  Moves ``served_slices_per_s``.  None
where the port records no such spans."""

from portbench.program_spans import device_share

MOVES = "served_slices_per_s"


def read(ctx):
    return device_share(ctx, "sampler.step", ("ddpm.attn",))
