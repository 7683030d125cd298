"""Model registry of the ported families, and their initialization
(counterpart: ``mrisr_tpu/models/registry.py``).

A fresh model is initialized as the JAX package's ``model.init`` does it
with flax's default initializers, not with torch's: conv and
transposed-conv kernels lecun-normal (a normal truncated at two standard
deviations, variance 1 / fan_in with fan_in = kh * kw * C_in), biases 0,
BatchNorm scale 1 and shift 0 with running statistics 0 and 1.  Torch's
default ``kaiming_uniform(a=sqrt(5))`` has a third of that variance and
would train a different model.  The draws come from a ``torch.Generator``
seeded with the training seed; they are not the JAX package's numbers
(a ``jax.random`` stream cannot be reproduced), only its distribution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mrisr_tpu_torch.config import PRESETS, ModelConfig
from mrisr_tpu_torch.models.unet import UNet

# truncated-normal stddev correction of flax's variance_scaling: the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

# name -> input kind of the models the port trains ('pair': (B, H, W, 2));
# the GAN generator, DeepCNN, the progressive UNet and the diffusion
# models train in later slices (ROADMAP.md, Queue 1 items 11-12)
TRAINABLE = {"unet": "pair", "unet_combined": "pair",
             "unet_distilled": "pair"}


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: truncated normal, variance
    1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialize every conv, transposed conv and BatchNorm of ``model``
    as flax's defaults would, from one generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):  # weight (C_in, C_out, kh, kw)
            w = m.weight
            lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], g)
        elif isinstance(m, nn.Conv2d):  # weight (C_out, C_in, kh, kw)
            lecun_normal_(m.weight, m.weight[0].numel(), g)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # scale 1, shift 0, stats 0 / 1
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model


def init_model(name: str, cfg: Optional[ModelConfig] = None, seed: int = 0
               ) -> Tuple[nn.Module, str]:
    """A freshly initialized trainable model and its input kind, on the
    CPU (the caller moves it)."""
    if name not in TRAINABLE:
        raise NotImplementedError(
            f"training {name!r} is not ported yet (ROADMAP.md, Queue 1 "
            "items 11-12); the port trains " + ", ".join(sorted(TRAINABLE)))
    if cfg is None:
        cfg = PRESETS[name].model if name in PRESETS else ModelConfig(name=name)
    model = UNet(features=cfg.base_features, in_channels=cfg.in_channels,
                 out_channels=cfg.out_channels)
    return flax_init_(model, seed), TRAINABLE[name]
