"""Structured logging + step-time meters (the port's copy of
``mrisr_tpu/utils/logging.py``).

Upgrades the reference's print/tqdm observability (SURVEY.md §5 "Tracing"):
same wall-clock-per-epoch and it/s numbers, but as structured records.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "mrisr", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class StepTimer:
    """Throughput meter: step times -> it/s and items/s (the reference's
    tqdm rate, e.g. ~3.2 it/s @ batch 4, SURVEY.md §6)."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self.steps = 0
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step

    def summary(self) -> Dict[str, float]:
        return {
            "steps": self.steps,
            "elapsed_s": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "items_per_sec": round(self.items_per_sec, 2),
        }
