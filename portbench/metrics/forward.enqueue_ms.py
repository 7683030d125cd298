"""forward: host milliseconds of one call into the engine's forward, the
int8_fused UNet, which returns before the device finishes (``core.apply_ms``).
Moves ``card_ms_per_slice``: where the launches fall behind the kernels,
the card idles inside the forward, and that time counts."""

from portbench.core import apply_ms as read  # noqa: F401

MOVES = "card_ms_per_slice"
