"""sampler: host milliseconds of one call into the engine's forward when it
is the Fast-DDPM sampler, all steps (``core.apply_ms``).  Moves
``served_slices_per_s``; far below the call's device time, it says the
host is not what holds the sampler back."""

from portbench.core import apply_ms as read  # noqa: F401

MOVES = "served_slices_per_s"
