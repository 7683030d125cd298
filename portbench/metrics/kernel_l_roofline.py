"""kernels: kernel L's (``csrc/layernorm_modulate.cu``: DiT's LayerNorm
and modulation) share of its roofline: the larger of its float32
operations over 67 TFLOP/s and its bytes (bf16 in, int8 codes or bf16
out, the (B, 2 C) float32 rows) over 3.35 TB/s, counted from the call
shapes in ``reference/counts_dit.py``, over its device time in the
profiled sub-window, the launches counted in whole forwards.  Moves
``served_slices_per_s``.  None where no such kernel ran."""

MOVES = "served_slices_per_s"
PATTERN = r"(?<![A-Za-z0-9_])layernorm_modulate_kernel"


def read(ctx):
    return ctx.roofline("kernel_l", PATTERN)
