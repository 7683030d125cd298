"""kernels: kernel A's (``csrc/conv_int8.cu``) share of its roofline:
the least time its sites could take (the larger of operations over
1,979 int8 TOP/s and bytes over 3.35 TB/s, counted from the call shapes
in ``reference/counts.py``) over its device time in the profiled
sub-window, the launches counted in whole forwards.  Moves
``card_ms_per_slice``."""

MOVES = "card_ms_per_slice"
PATTERN = r"(?<![A-Za-z0-9_])(conv_int8_kernel|conv_int8_tc_kernel|conv1x1_to1_kernel)"


def read(ctx):
    return ctx.roofline("kernel_a", PATTERN)
