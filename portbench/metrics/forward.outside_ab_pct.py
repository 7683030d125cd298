"""forward: the share of the int8 UNet forward's card time spent outside
the hand-written conv kernels: 100 less the device time of the port's
``unet.conv`` and ``unet.upconv`` spans (kernels A and B, the final 1x1
conv) as a share of the device time of the ``unet.forward`` span around
them, the median over the forwards recorded whole in the profiled
sub-window (CUDA events on the engine's stream, ``program_spans``).  The int8
max-pool, the input's quantization and any wait for launches inside a
forward count as outside.  Moves ``card_ms_per_slice``.  None where the
port records no such spans."""

from portbench.program_spans import device_share

MOVES = "card_ms_per_slice"


def read(ctx):
    inside = device_share(ctx, "unet.forward", ("unet.conv", "unet.upconv"))
    return None if inside is None else 100.0 - inside
