"""sampler: the share of the Fast-DDPM sampler's card time spent in the
float GroupNorm + SiLU chain (the sites K3 does not take): the device
time of the port's ``ddpm.gn_chain`` spans over that of the
``sampler.step`` span around them, the median over the steps recorded
whole in the profiled sub-window (CUDA events on the engine's stream,
``program_spans``).  Moves ``served_slices_per_s``.  None where the port
records no such spans."""

from portbench.program_spans import device_share

MOVES = "served_slices_per_s"


def read(ctx):
    return device_share(ctx, "sampler.step", ("ddpm.gn_chain",))
