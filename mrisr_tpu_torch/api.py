"""Public API: the reference's ``load_model`` contract (counterpart:
``mrisr_tpu/api.py``).

``load_model(name)`` searches checkpoints as ``mrisr_tpu.api.load_model``
does and returns a :class:`LoadedModel` with the reference's NCHW call
contract, ``(B, 2, H, W) -> (B, 1, H, W)``, and the NHWC fast path the
eval code uses.  This slice ports the pair UNets; the other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm
from mrisr_tpu_torch.ckpt.torch_ckpt import load_reference_state_dict
from mrisr_tpu_torch.config import PRESETS, ModelConfig
from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.models import UNet

# pair UNets of the registry (mrisr_tpu/models/registry.py): the GAN
# generator's convs are bias-free
PAIR_UNETS = ("unet", "unet_combined", "unet_gan", "unet_distilled")
NOT_PORTED = {
    "deepcnn": "ROADMAP.md, Queue 1 item 11",
    "progressive_unet": "ROADMAP.md, Queue 1 item 11",
    "patchgan": "ROADMAP.md, Queue 1 item 11",
    "fastddpm": "ROADMAP.md, Queue 1 item 12",
    "fastddpm_simple": "ROADMAP.md, Queue 1 item 12",
}

# the reference's checkpoint file names (reference src/ModelLoader.py:662-669)
_TORCH_CKPT_FILES = {
    "unet": "unet_best.pt",
    "unet_combined": "unet_combined_best.pt",
    "deepcnn": "deepcnn_best.pt",
    "progressive_unet": "progressive_unet_best.pt",
    "unet_gan": "unet_gan_best.pt",
    "fastddpm": "fastddpm_best.pt",
    "fastddpm_simple": "fastddpm_advanced_best.pth",
}


@dataclass
class LoadedModel:
    """An eval-ready pair model on ``device``."""

    name: str
    module: nn.Module
    kind: str  # 'pair'
    device: torch.device

    @torch.no_grad()
    def predict_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 2) -> (B, H, W, 1)`` float32 on the model's device.
        The forward runs in full float32 (TF32 off): the metric it feeds
        is the reference's float model's."""
        with fp32_reference():
            return self.module(x.to(self.device, torch.float32))

    def __call__(self, x_nchw) -> torch.Tensor:
        """``(B, 2, H, W) -> (B, 1, H, W)``."""
        x = torch.as_tensor(x_nchw, dtype=torch.float32).permute(0, 2, 3, 1)
        return self.predict_nhwc(x).permute(0, 3, 1, 2)


def _orbax_error(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path} is an Orbax checkpoint, which the port cannot read without "
        "JAX (ROADMAP.md, Queue 1 item 7); convert it to the reference's "
        "torch layout, or pass checkpoint=<file.pt>")


def load_model(
    model_name: str,
    models_dir: str = "models",
    checkpoint: Optional[str] = None,
    cfg: Optional[ModelConfig] = None,
    fold_bn: bool = False,
    device: DeviceLike = None,
) -> LoadedModel:
    """Load the best checkpoint for ``model_name`` onto ``device``
    (``None``: the card).

    Search order, as the JAX package's: an explicit ``checkpoint`` path;
    the Orbax dir ``<models_dir>/<name>_best`` (raises: it needs JAX); the
    reference torch file ``<models_dir>/<torch name>``.  With none found,
    fresh weights (seeded), unless ``checkpoint='required'``, which raises.
    ``fold_bn`` folds BatchNorm into the convs (exact in eval)."""
    name = model_name.lower()
    base = re.sub(r"_steps\d+$", "", name)
    if base in NOT_PORTED:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet ({NOT_PORTED[base]})")
    if name not in PAIR_UNETS:
        raise ValueError(f"Unknown model: {model_name}. Choose from: "
                         f"{sorted(PAIR_UNETS + tuple(NOT_PORTED))}")
    device = resolve_device(device)
    if cfg is None:
        cfg = PRESETS[name].model if name in PRESETS else ModelConfig(name=name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = UNet(features=cfg.base_features, use_bias=name != "unet_gan",
                      in_channels=cfg.in_channels,
                      out_channels=cfg.out_channels)

    require = checkpoint == "required"
    if require:
        checkpoint = None
    orbax_path = os.path.join(models_dir, f"{name}_best")
    torch_path = os.path.join(models_dir, _TORCH_CKPT_FILES.get(name, ""))
    path = None
    if checkpoint:
        # an explicit path must exist: falling back to another checkpoint
        # would report metrics for the wrong model on a typo
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(f"checkpoint not found: {checkpoint}")
        if os.path.isdir(checkpoint):
            raise _orbax_error(checkpoint)
        path = checkpoint
    elif os.path.isdir(orbax_path):
        raise _orbax_error(orbax_path)
    elif name in _TORCH_CKPT_FILES and os.path.isfile(torch_path):
        path = torch_path
    elif require:
        raise FileNotFoundError(f"Checkpoint not found for {name} in "
                                f"{models_dir}")
    if path is not None:
        load_reference_state_dict(
            module, torch.load(path, map_location="cpu", weights_only=True))
    module = module.eval()
    if fold_bn:
        module = fold_unet_batchnorm(module)
    return LoadedModel(name=name, module=module.to(device), kind="pair",
                       device=device)
