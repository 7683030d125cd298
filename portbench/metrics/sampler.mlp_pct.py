"""sampler: the share of the sampler's card time that DiT's MLP halves
take (kernel L before ``fc1``, A's ``fc1`` in its GELU form and ``fc2``,
kernel E's gated residual): the device time of the port's ``dit.mlp``
spans over that of the ``sampler.step`` span around them, the median over
the steps recorded whole in the profiled sub-window (CUDA events on the
engine's stream, ``program_spans``).  Moves ``served_slices_per_s``.  None
where the port records no such spans."""

from portbench import program_spans

MOVES = "served_slices_per_s"
INNER = "dit.mlp"


def read(ctx):
    if not any(s.name == INNER for s in program_spans.recorded(ctx)):
        return None
    return program_spans.device_share(ctx, "sampler.step", (INNER,))
