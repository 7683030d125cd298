"""kernels: kernel B's (``csrc/upconv_int8.cu``) share of its roofline,
counted as kernel A's is.  Moves ``card_ms_per_slice``."""

MOVES = "card_ms_per_slice"
PATTERN = r"(?<![A-Za-z0-9_])upconv_int8(_tc)?_kernel"


def read(ctx):
    return ctx.roofline("kernel_b", PATTERN)
