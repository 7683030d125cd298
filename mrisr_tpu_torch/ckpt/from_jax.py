"""flax UNet variables -> port ``UNet`` state dict (the weight carry).

The inverse of the reference's torch -> flax converter
(``mrisr_tpu/ckpt/torch_convert.py``):

- Conv           HWIO -> (O, I, kh, kw)
- ConvTranspose  HWIO -> (I, O, kh, kw) with the spatial flip [::-1, ::-1]:
  flax applies the kernel flipped relative to torch's ConvTranspose2d
- BatchNorm      scale/bias + batch_stats mean/var ->
                 weight/bias/running_mean/running_var

Both trees are accepted: unfolded (``{'params', 'batch_stats'}`` with
``BatchNorm_0/1``) loads into ``UNet()``, BN-folded (``{'params'}`` only)
into ``UNet(use_bn=False)``.  Leaves are numpy arrays (``np.asarray`` of a
jax array is one).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mrisr_tpu_torch.models.unet import BLOCKS_DOWN, BLOCKS_UP


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def conv_weight(kernel) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def convt_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch (I, O, kh, kw)."""
    return _t(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def conv_kernel_hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv2d weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O)."""
    return weight.detach().permute(2, 3, 1, 0)


def convt_kernel_hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (I, O, kh, kw) -> flax kernel
    (kh, kw, I, O), spatially flipped."""
    return weight.detach().permute(2, 3, 0, 1).flip(0, 1)


def unet_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    folded = "BatchNorm_0" not in params["enc1"]
    sd: Dict[str, torch.Tensor] = {}
    for name in (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP):
        sub = params[name]
        for i, cn in enumerate(("Conv_0", "Conv_1")):
            # Sequential index of the conv: 0/3 with BN, 0/2 folded
            idx = 2 * i if folded else 3 * i
            sd[f"{name}.conv.{idx}.weight"] = conv_weight(sub[cn]["kernel"])
            if "bias" in sub[cn]:
                sd[f"{name}.conv.{idx}.bias"] = _t(sub[cn]["bias"])
            if not folded:
                bn, p = f"BatchNorm_{i}", f"{name}.conv.{idx + 1}"
                sd[f"{p}.weight"] = _t(sub[bn]["scale"])
                sd[f"{p}.bias"] = _t(sub[bn]["bias"])
                sd[f"{p}.running_mean"] = _t(stats[name][bn]["mean"])
                sd[f"{p}.running_var"] = _t(stats[name][bn]["var"])
                sd[f"{p}.num_batches_tracked"] = torch.tensor(0)
    for lvl in (4, 3, 2, 1):
        sub = params[f"upconv{lvl}"]
        sd[f"upconv{lvl}.weight"] = convt_weight(sub["kernel"])
        sd[f"upconv{lvl}.bias"] = _t(sub["bias"])
    sd["final.weight"] = conv_weight(params["final"]["kernel"])
    sd["final.bias"] = _t(params["final"]["bias"])
    return sd
