"""Evaluation layer: metrics (V6/V11), volume-level prediction (V7-V9),
the per-spacing test-set runner and the comparison figures (V7-V10,
``figures.py``, matplotlib imported when a figure is drawn)."""

from mrisr_tpu_torch.eval.metrics import (  # noqa: F401
    compute_metrics,
    per_sample_metrics,
    spacing_metrics,
)
from mrisr_tpu_torch.eval.volume_eval import (  # noqa: F401
    predict_volume,
    predict_volume_hierarchical,
    predict_volume_progressive,
)
