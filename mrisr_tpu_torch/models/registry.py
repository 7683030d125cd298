"""Model registry of the ported families, and their initialization
(counterpart: ``mrisr_tpu/models/registry.py``).

A fresh model is initialized as the JAX package's ``model.init`` does it
with its flax modules' initializers, not with torch's: conv, transposed-conv
and dense kernels lecun-normal (a normal truncated at two standard
deviations, variance 1 / fan_in with fan_in = kh * kw * C_in), biases 0,
BatchNorm and GroupNorm scale 1 and shift 0, running statistics 0 and 1;
DeepCNN's convs kaiming-normal over fan-out (a plain normal, variance
2 / (kh * kw * C_out): ``mrisr_tpu/models/blocks.py:kaiming_normal_fan_out``).
Torch's default ``kaiming_uniform(a=sqrt(5))`` has a third of the
lecun variance and would train a different model.  The draws come from a
``torch.Generator`` seeded with the training seed; they are not the JAX
package's numbers (a ``jax.random`` stream cannot be reproduced), only its
distribution.  ``dtype`` is flax's compute dtype (``models/blocks.py``):
the parameters and their init are float32 whatever it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mrisr_tpu_torch.config import PRESETS, ModelConfig
from mrisr_tpu_torch.models.adm_unet import ADMUNet
from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
from mrisr_tpu_torch.models.deepcnn import DeepCNN
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet, SimpleDiffusionUNet
from mrisr_tpu_torch.models.dit import DiT
from mrisr_tpu_torch.models.discriminator import PatchGAN
from mrisr_tpu_torch.models.progressive import ProgressiveUNet
from mrisr_tpu_torch.models.unet import UNet

# a state dict's buffers: BatchNorm's running statistics and counter (flax's
# batch_stats, which the JAX package's param_count leaves out), and DiT's
# fixed position table
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked",
            "pos_embed")
# truncated-normal stddev correction of flax's variance_scaling: the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

# name -> input kind: 'pair' (B, H, W, 2) [pre, post] (PatchGAN: the
# (B, H, W, 3) [pre, post, candidate]), 'window' (B, H, W, 5) [i .. i+4],
# 'diffusion' (B, H, W, 3) + (B,) t.  'fastddpm_pmub' (the DDPM UNet that
# Fast-DDPM publishes, models/ddpm_unet.py), 'fastddpm_adm' (ADM's UNet,
# models/adm_unet.py) and 'fastddpm_dit' (DiT-XL/8, models/dit.py) are the
# port's own: the JAX package has no such models
TRAINABLE = {"unet": "pair", "unet_combined": "pair",
             "unet_distilled": "pair", "unet_gan": "pair",
             "deepcnn": "pair", "progressive_unet": "window",
             "fastddpm": "diffusion", "fastddpm_simple": "diffusion",
             "patchgan": "pair", "fastddpm_pmub": "diffusion",
             "fastddpm_adm": "diffusion", "fastddpm_dit": "diffusion"}


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
    """Re-initialize every conv, transposed conv, dense layer, BatchNorm
    and GroupNorm of ``model`` as flax's defaults would, from one generator
    seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):  # weight (C_in, C_out, kh, kw)
            w = m.weight
            lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], g)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):  # weight (C_out, ...)
            lecun_normal_(m.weight, m.weight[0].numel(), g)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()  # scale 1, shift 0 (BN: stats 0 / 1)
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model


@torch.no_grad()
def kaiming_fan_out_init_(model: nn.Module, seed: int) -> nn.Module:
    """DeepCNN's init: every conv kaiming-normal over fan-out (no
    truncation), biases 0; BatchNorm scale 1, shift 0, stats 0 / 1."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):  # weight (C_out, C_in, kh, kw)
            w = m.weight
            std = (2.0 / (w.shape[0] * w.shape[2] * w.shape[3])) ** 0.5
            w.normal_(0.0, std, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def create_model(name: str, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The module of registry ``name`` at ``cfg``'s width (torch's default
    init) computing in ``dtype`` (None: float32), as the JAX registry
    builds it: the GAN generator and the progressive stages bias-free,
    Fast-DDPM's input [pre, post, x_noisy] whatever ``cfg.in_channels``
    says, the simple lineage's time_dim 256, ADM's two outputs a channel
    (the noise, then the learned variance) and DiT's (``base_features`` its
    width, the rest DiT-XL/8's), and ``cfg.remat`` read by the four UNets
    only."""
    f = cfg.base_features
    if name in ("unet", "unet_combined", "unet_distilled", "unet_gan"):
        return UNet(features=f, use_bias=name != "unet_gan",
                    in_channels=cfg.in_channels,
                    out_channels=cfg.out_channels, dtype=dtype,
                    remat=cfg.remat)
    if name == "deepcnn":
        return DeepCNN(in_channels=cfg.in_channels,
                       out_channels=cfg.out_channels, base_features=f,
                       num_blocks=tuple(cfg.num_blocks), dtype=dtype)
    if name == "progressive_unet":
        return ProgressiveUNet(base_features=f, dtype=dtype)
    if name == "fastddpm":
        return FastDDPMUNet(base_features=f, time_dim=cfg.time_dim,
                            out_channels=cfg.out_channels, dtype=dtype)
    if name == "fastddpm_simple":
        return SimpleDiffusionUNet(base_features=f, time_dim=256, dtype=dtype)
    if name == "fastddpm_pmub":
        return DDPMUNet(base_features=f, time_dim=cfg.time_dim,
                        out_channels=cfg.out_channels, dtype=dtype)
    if name == "fastddpm_adm":  # learn_sigma: the noise and a variance
        return ADMUNet(base_features=f, time_dim=cfg.time_dim,
                       out_channels=2 * cfg.out_channels, dtype=dtype)
    if name == "fastddpm_dit":  # learn_sigma, as ADM's
        return DiT(hidden=f, out_channels=2 * cfg.out_channels, dtype=dtype)
    if name == "patchgan":
        return PatchGAN(base_features=f, dtype=dtype)
    raise ValueError(f"Unknown model: {name}. Choose from: "
                     f"{sorted(TRAINABLE)}")


def init_model(name: str, cfg: Optional[ModelConfig] = None, seed: int = 0,
               dtype: Optional[torch.dtype] = None) -> Tuple[nn.Module, str]:
    """A freshly initialized model of registry ``name`` and its input
    kind, on the CPU (the caller moves it), computing in ``dtype``."""
    if name not in TRAINABLE:
        raise ValueError(f"Unknown model: {name}. Choose from: "
                         f"{sorted(TRAINABLE)}")
    if cfg is None:
        cfg = PRESETS[name].model if name in PRESETS else ModelConfig(name=name)
    model = create_model(name, cfg, dtype)
    init = kaiming_fan_out_init_ if name == "deepcnn" else flax_init_
    return init(model, seed), TRAINABLE[name]


def param_count(module_or_state_dict) -> int:
    """The number of parameters of a module, or of a state dict without
    its buffers: what the JAX package's ``param_count(variables['params'])``
    counts."""
    if isinstance(module_or_state_dict, nn.Module):
        return sum(p.numel() for p in module_or_state_dict.parameters())
    return sum(v.numel() for k, v in module_or_state_dict.items()
               if k.rsplit(".", 1)[-1] not in _BUFFERS)
