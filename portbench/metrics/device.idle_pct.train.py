"""device: the idle share (``core.idle_pct``) over one whole profiled
training epoch.  Moves ``train_slices_per_s``."""

from portbench.core import idle_pct as read  # noqa: F401

MOVES = "train_slices_per_s"
