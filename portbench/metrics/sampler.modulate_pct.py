"""sampler: the share of the sampler's card time that DiT's modulation
layer takes (kernel L's LayerNorm and modulation, and kernel E's gated
residuals): the device time of the port's ``dit.modulate`` spans over that
of the ``sampler.step`` span around them, the median over the steps
recorded whole in the profiled sub-window (CUDA events on the engine's
stream, ``program_spans``).  Moves ``served_slices_per_s``.  None where
the port records no such spans."""

from portbench import program_spans

MOVES = "served_slices_per_s"
INNER = "dit.modulate"


def read(ctx):
    if not any(s.name == INNER for s in program_spans.recorded(ctx)):
        return None
    return program_spans.device_share(ctx, "sampler.step", (INNER,))
