"""Training history artifacts: JSON and loss-curve PNG (counterpart:
``mrisr_tpu/train/history.py``).

The same JSON schema as the JAX package's: each per-epoch series as a list,
the extra fields (``best_val_loss``), the run's ``config`` and a
``timestamp``.  The PNG is best effort: matplotlib is imported when the
curves are drawn, and a machine without it skips them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional


def _to_jsonable(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if hasattr(x, "item"):
        return x.item()
    return x


class TrainingHistory:
    """Per-epoch scalar series and arbitrary final fields."""

    def __init__(self, config: Optional[dict] = None):
        self.series: Dict[str, List[float]] = {}
        self.extra: Dict[str, Any] = {}
        self.config = config or {}

    def append(self, **metrics: float) -> None:
        for k, v in metrics.items():
            self.series.setdefault(k, []).append(float(v))

    def set(self, **fields: Any) -> None:
        self.extra.update(fields)

    def to_dict(self) -> dict:
        return _to_jsonable({**self.series, **self.extra,
                             "config": self.config,
                             "timestamp": datetime.now().isoformat()})

    def save_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def save_curves_png(self, path: str, keys=("train_loss", "val_loss"),
                        title: str = "Training") -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # plotting is best effort
            return
        plt.figure(figsize=(10, 6))
        for k in keys:
            if k in self.series:
                plt.plot(self.series[k], label=k.replace("_", " "),
                         linewidth=2)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title(title)
        plt.legend()
        plt.grid(True, alpha=0.3)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
