"""flax variables -> port state dicts (the weight carry): ``UNet`` and
``FastDDPMUNet``, and the FastDDPM param tree back out of a port model.

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


# FastDDPMUNet: flax module path -> the reference's (and the port's) name.
# Dense kernels are (I, O), torch Linear weights (O, I); GroupNorm's
# scale/bias are weight/bias.
_FASTDDPM_DENSE = (("time_emb", "Dense_0", "time_emb.fc.0"),
                   ("time_emb", "Dense_1", "time_emb.fc.2"))
DIFFUSION_BLOCKS = ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2",
                    "dec1")


def _fastddpm_layers(params: Dict):
    """``(kind, flax sub-tree, torch prefix)`` of every FastDDPMUNet layer;
    kind is 'conv', 'convt', 'dense' or 'norm'."""
    for outer, inner, prefix in _FASTDDPM_DENSE:
        yield "dense", params[outer][inner], prefix
    yield "conv", params["init_conv"], "init_conv"
    for res in DIFFUSION_BLOCKS:
        p = params[res]
        yield "norm", p["norm1"], f"{res}.norm1"
        yield "conv", p["conv1"], f"{res}.conv1"
        yield "dense", p["time_fc"], f"{res}.time_fc"
        yield "norm", p["norm2"], f"{res}.norm2"
        yield "conv", p["conv2"], f"{res}.conv2"
        if "skip" in p:
            yield "conv", p["skip"], f"{res}.skip"
    for lvl in (3, 2, 1):
        yield "convt", params[f"upconv{lvl}"], f"upconv{lvl}"
    yield "norm", params["final_norm"], "final.0"
    yield "conv", params["final_conv"], "final.2"


def fastddpm_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``FastDDPMUNet`` variables -> the port's (= the reference's)
    state dict: Dense kernels transposed, conv kernels HWIO -> OIHW, the
    ConvTranspose flip as in :func:`convt_weight`, GroupNorm scale/bias ->
    weight/bias."""
    sd: Dict[str, torch.Tensor] = {}
    for kind, sub, prefix in _fastddpm_layers(variables["params"]):
        if kind == "conv":
            w = conv_weight(sub["kernel"])
        elif kind == "convt":
            w = convt_weight(sub["kernel"])
        elif kind == "dense":
            w = _t(np.asarray(sub["kernel"]).T)
        else:
            w = _t(sub["scale"])
        sd[f"{prefix}.weight"] = w
        sd[f"{prefix}.bias"] = _t(sub["bias"])
    return sd


def fastddpm_flax_params(model) -> Dict:
    """A port ``FastDDPMUNet`` -> the flax param tree (torch tensors on the
    model's device, float32): the layout the serving tables, bundles and
    ``serve/quant_diffusion.py`` read."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    tree: Dict = {}

    def put(path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    names = {"time_emb.fc.0": ("time_emb", "Dense_0"),
             "time_emb.fc.2": ("time_emb", "Dense_1"),
             "final.0": ("final_norm",), "final.2": ("final_conv",)}
    for key, w in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        path = names.get(prefix, tuple(prefix.split(".")))
        if leaf == "bias":
            put(path + ("bias",), w)
        elif w.ndim == 1:  # GroupNorm
            put(path + ("scale",), w)
        elif w.ndim == 2:  # Linear
            put(path + ("kernel",), w.t().contiguous())
        elif path[0].startswith("upconv"):
            put(path + ("kernel",), convt_kernel_hwio(w).contiguous())
        else:
            put(path + ("kernel",), conv_kernel_hwio(w).contiguous())
    return tree
