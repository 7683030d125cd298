"""Serving: int8 quantization (quant.py), bundles (bundle.py), the
micro-batching engine (engine.py) and its HTTP front end (http.py), and
distillation: the half-width student (distill.py, prune.py) and the
few-step Fast-DDPM students (distill_diffusion.py)."""

from mrisr_tpu_torch.serve.bundle import (  # noqa: F401
    engine_from_bundle,
    load_bundle,
    make_bundle_apply,
    save_bundle,
)
from mrisr_tpu_torch.serve.engine import (  # noqa: F401
    EngineStats,
    InferenceEngine,
    data_parallel_apply,
    engine_from_model,
)
from mrisr_tpu_torch.serve.quant import (  # noqa: F401
    Int8FusedUNet,
    Int8UNet,
    calibrate_unet,
    quantize_unet,
    unet_int8_apply,
    unet_int8_fused_apply,
)
