"""VGG16 perceptual feature distance (counterpart: ``mrisr_tpu/losses/vgg.py``).

- The VGG16 conv stack through relu3_3 (7 convs; 2x2 max-pools after the
  first two stages).
- A 1-channel image is replicated to 3 channels; no ImageNet
  re-normalization (inputs are already standardized).
- Weights load from the JAX package's npz: HWIO arrays ``conv{i}_kernel``
  and ``conv{i}_bias`` (``MRISR_VGG16_NPZ`` or an explicit path), which
  :func:`convert_torch_vgg16` writes from torchvision's VGG16 state dict.
- Without weights, ``load_vgg16_params`` builds a fixed seeded init in the
  flax default form (lecun-normal kernels, zero biases) from a
  ``torch.Generator``; its draws are not the JAX package's (a
  ``jax.random`` stream cannot be reproduced), so 'vgg-random' is the same
  distribution there and here, not the same numbers.
- Distance: L1 over the features.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.registry import lecun_normal_

# VGG16 conv plan through relu3_3: (features, layers in the stage)
_VGG16_PLAN = ((64, 2), (128, 2), (256, 3))
_RANDOM_SEED = 1234  # the JAX package's PRNGKey for the random fallback


class VGG16Features(nn.Module):
    """VGG16 conv stack through relu3_3; NCHW in, the final feature map out."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for feat, n_layers in _VGG16_PLAN:
            for _ in range(n_layers):
                setattr(self, f"conv{i}", nn.Conv2d(cin, feat, 3, padding=1))
                cin, i = feat, i + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for stage, (_, n_layers) in enumerate(_VGG16_PLAN):
            for _ in range(n_layers):
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
            if stage < len(_VGG16_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x


def load_vgg16_params(npz_path: Optional[str] = None,
                      allow_env: bool = True) -> Dict[str, torch.Tensor]:
    """VGG16Features' state dict from the npz, or the fixed seeded init.

    ``allow_env=False`` ignores MRISR_VGG16_NPZ: the explicit 'vgg-random'
    mode must stay random even when real weights are around."""
    if allow_env:
        npz_path = npz_path or os.environ.get("MRISR_VGG16_NPZ")
    sd: Dict[str, torch.Tensor] = {}
    if npz_path and os.path.exists(npz_path):
        data = np.load(npz_path)
        for i in range(7):
            k = np.asarray(data[f"conv{i}_kernel"], np.float32)  # HWIO
            sd[f"conv{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            sd[f"conv{i}.bias"] = torch.from_numpy(
                np.asarray(data[f"conv{i}_bias"], np.float32))
        return sd
    g = torch.Generator().manual_seed(_RANDOM_SEED)
    for name, p in VGG16Features().state_dict().items():
        if name.endswith("bias"):
            sd[name] = torch.zeros_like(p)
        else:
            sd[name] = lecun_normal_(torch.empty_like(p), p[0].numel(), g)
    return sd


# torchvision's ``vgg16().features`` indices of the first 7 convs
_TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14)


def convert_torch_vgg16(state_dict, out_npz: str) -> None:
    """torchvision's VGG16 state dict (keys ``features.{i}.weight`` and
    ``features.{i}.bias``) -> the npz :func:`load_vgg16_params` reads, the
    JAX package's file: ``conv{i}_kernel`` HWIO and ``conv{i}_bias``."""
    arrs = {}
    for i, ti in enumerate(_TORCHVISION_CONVS):
        w = _numpy(state_dict[f"features.{ti}.weight"])  # (O, I, H, W)
        arrs[f"conv{i}_kernel"] = w.transpose(2, 3, 1, 0)
        arrs[f"conv{i}_bias"] = _numpy(state_dict[f"features.{ti}.bias"])
    np.savez(out_npz, **arrs)


def _numpy(a) -> np.ndarray:
    return torch.as_tensor(a).detach().cpu().numpy()


def make_perceptual_fn(npz_path: Optional[str] = None,
                       dtype: torch.dtype = torch.float32,
                       allow_env: bool = True):
    """``perceptual(pred, target)`` -> scalar L1 distance of the VGG16
    features of ``(B, H, W, 1)`` images; the network moves to each input's
    device at its first call."""
    sd = load_vgg16_params(npz_path, allow_env=allow_env)
    on: Dict[torch.device, VGG16Features] = {}

    def model(device: torch.device) -> VGG16Features:
        if device not in on:
            m = VGG16Features()
            m.load_state_dict(sd)
            on[device] = m.to(device, dtype).eval().requires_grad_(False)
        return on[device]

    def perceptual(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        # one concatenated forward instead of two
        both = torch.cat([pred, target], dim=0).permute(0, 3, 1, 2)
        f = model(pred.device)(both.expand(-1, 3, -1, -1).to(dtype))
        n = pred.shape[0]
        return (f[:n] - f[n:]).abs().mean()

    return perceptual
