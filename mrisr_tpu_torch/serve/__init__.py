"""Serving: int8 quantization (quant.py), bundles (bundle.py) and the
micro-batching engine (engine.py)."""

from mrisr_tpu_torch.serve.bundle import (  # noqa: F401
    engine_from_bundle,
    load_bundle,
    make_bundle_apply,
    save_bundle,
)
from mrisr_tpu_torch.serve.engine import EngineStats, InferenceEngine  # noqa: F401
from mrisr_tpu_torch.serve.quant import (  # noqa: F401
    Int8FusedUNet,
    calibrate_unet,
    quantize_unet,
    unet_int8_fused_apply,
)
