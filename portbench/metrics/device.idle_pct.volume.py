"""device: the idle share (``core.idle_pct``) under volumes arriving on a
schedule.  Moves ``volume_p95_ms``."""

from portbench.core import idle_pct as read  # noqa: F401

MOVES = "volume_p95_ms"
