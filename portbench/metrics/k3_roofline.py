"""kernels: K3's (``csrc/groupnorm_silu.cu``) share of its roofline: the
larger of its float32 operations over 67 TFLOP/s and its bytes (bf16 in,
int8 out) over 3.35 TB/s, over its device time in the profiled
sub-window.  Moves ``served_slices_per_s``."""

MOVES = "served_slices_per_s"
PATTERN = r"(?<![A-Za-z0-9_])gn_silu_kernel"


def read(ctx):
    return ctx.roofline("k3", PATTERN)
