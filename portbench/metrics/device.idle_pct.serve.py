"""device: the share of the profiled sub-window in which no kernel, copy
or set ran on the card (``core.idle_pct``), under saturating traffic.
Moves ``served_slices_per_s``."""

from portbench.core import idle_pct as read  # noqa: F401

MOVES = "served_slices_per_s"
