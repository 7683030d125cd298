"""Traffic generators, one module a loop kind, named by a traffic mix's
``loop``.  Each has ``run(engine, pool, traffic, seed, seconds, window,
sample_size, rows)`` and returns a :class:`LoopOut`."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class LoopOut:
    window: Tuple[float, float] = (0.0, 0.0)
    metrics: Dict[str, Tuple[float, str]] = field(default_factory=dict)
    rate: Optional[float] = None  # slices resolved a second in the window
    samples: List[Tuple[int, int, Any, Optional[int]]] = field(
        default_factory=list)     # (volume, pair, answer, batch row)
    attempted: int = 0
    failed: int = 0
    marks: List[Tuple[float, int]] = field(default_factory=list)
    lines: List[str] = field(default_factory=list)
    latency_ms: Any = None        # open loop: each volume's
    lateness_ms: Any = None       # open loop: the generator's, each volume


class Marks:
    """One ``(time, batch ordinal)`` a resolved request, recorded in the
    engine's thread as the future resolves: the ordinal is the engine's
    batch count, which it raises before it resolves a batch."""

    def __init__(self, engine):
        self.engine = engine
        self.items: List[Tuple[float, int]] = []

    def record(self, fut) -> None:
        self.items.append((time.perf_counter(), self.engine.stats.batches))

