"""PyTorch/CUDA port of ``mrisr_tpu`` for one NVIDIA H100.

The JAX package ``mrisr_tpu`` is the reference this package is tested
against; this package imports nothing of it (nor jax/flax/optax).  Public
functions keep the reference's NHWC layout: ``(B, H, W, 2) -> (B, H, W, 1)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On
a CPU tensor every kernel wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel (``csrc/``) or raises.
"""

from mrisr_tpu_torch.device import fp32_reference, resolve_device  # noqa: F401
