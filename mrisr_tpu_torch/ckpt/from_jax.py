"""flax variables -> port state dicts (the weight carry) for every family:
``UNet`` (and the GAN generator), ``ProgressiveUNet``, ``DeepCNN``,
``PatchGAN``, ``FastDDPMUNet`` and ``SimpleDiffusionUNet``; and the
BN-folded UNet's and the FastDDPM's param trees back out of a port model.

The inverse of the reference's torch -> flax converter
(``mrisr_tpu/ckpt/torch_convert.py``):

- Conv           HWIO -> (O, I, kh, kw)
- ConvTranspose  HWIO -> (I, O, kh, kw) with the spatial flip [::-1, ::-1]:
  flax applies the kernel flipped relative to torch's ConvTranspose2d
- Dense          (I, O) -> (O, I)
- BatchNorm      scale/bias + batch_stats mean/var ->
                 weight/bias/running_mean/running_var
- GroupNorm      scale/bias -> weight/bias

Both UNet trees are accepted: unfolded (``{'params', 'batch_stats'}`` with
``BatchNorm_0/1``) loads into ``UNet()``, BN-folded (``{'params'}`` only)
into ``UNet(use_bn=False)``.  Leaves are numpy arrays (``np.asarray`` of a
jax array is one); a tree of gradients converts as a tree of parameters.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

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


def unet_flax_params(model) -> Dict:
    """A port ``UNet`` -> its flax tree (torch tensors on the model's
    device, float32): ``{'params': ...}`` of ``UNet(use_bn=False)`` for a
    BN-folded model (the layout of the reference's ``quant='none'`` pair
    bundles), ``{'params', 'batch_stats'}`` with ``BatchNorm_0/1`` for one
    with BatchNorm (the inverse of :func:`unet_state_dict_from_flax`)."""
    params: Dict = {}
    stats: Dict = {}
    for name in (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP):
        block = getattr(model, name)
        params[name] = {}
        for i, c in enumerate(block.convs()):
            conv = {"kernel": conv_kernel_hwio(c.weight).contiguous()}
            if c.bias is not None:
                conv["bias"] = c.bias.detach()
            params[name][f"Conv_{i}"] = conv
        if model.use_bn:
            bns = [m for m in block.conv
                   if isinstance(m, torch.nn.BatchNorm2d)]
            stats[name] = {}
            for i, bn in enumerate(bns):
                params[name][f"BatchNorm_{i}"] = {
                    "scale": bn.weight.detach(), "bias": bn.bias.detach()}
                stats[name][f"BatchNorm_{i}"] = {"mean": bn.running_mean,
                                                 "var": bn.running_var}
    for lvl in (4, 3, 2, 1):
        up = getattr(model, f"upconv{lvl}")
        params[f"upconv{lvl}"] = {
            "kernel": convt_kernel_hwio(up.weight).contiguous(),
            "bias": up.bias.detach()}
    params["final"] = {"kernel": conv_kernel_hwio(model.final.weight
                                                  ).contiguous(),
                       "bias": model.final.bias.detach()}
    return {"params": params, "batch_stats": stats} if model.use_bn else {
        "params": params}


def progressive_state_dict_from_flax(variables: Dict
                                     ) -> Dict[str, torch.Tensor]:
    """flax ``ProgressiveUNet`` -> ``unet1.*``, ``unet2.*``, ``unet3.*``."""
    sd: Dict[str, torch.Tensor] = {}
    for stage in ("unet1", "unet2", "unet3"):
        sub = {"params": variables["params"][stage],
               "batch_stats": variables.get("batch_stats", {}).get(stage, {})}
        sd.update({f"{stage}.{k}": v
                   for k, v in unet_state_dict_from_flax(sub).items()})
    return sd


# (kind, flax path, torch prefix); kind is 'conv', 'convt', 'dense', 'gn'
# (GroupNorm) or 'bn' (BatchNorm, with its running statistics)
Layers = Iterable[Tuple[str, Tuple[str, ...], str]]


def _get(tree: Dict, path: Sequence[str]):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_layers(variables: Dict, layers: Layers
                           ) -> Dict[str, torch.Tensor]:
    """Carry each listed flax layer to its torch prefix."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for kind, path, prefix in layers:
        sub = _get(params, path)
        if kind == "conv":
            sd[f"{prefix}.weight"] = conv_weight(sub["kernel"])
        elif kind == "convt":
            sd[f"{prefix}.weight"] = convt_weight(sub["kernel"])
        elif kind == "dense":
            sd[f"{prefix}.weight"] = _t(np.asarray(sub["kernel"]).T)
        else:  # 'gn', 'bn'
            sd[f"{prefix}.weight"] = _t(sub["scale"])
        if "bias" in sub:
            sd[f"{prefix}.bias"] = _t(sub["bias"])
        if kind == "bn":
            st = _get(stats, path)
            sd[f"{prefix}.running_mean"] = _t(st["mean"])
            sd[f"{prefix}.running_var"] = _t(st["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def deepcnn_layers(params: Dict) -> Layers:
    """DeepCNN: ``layer{L}_block{b}`` -> ``layer{L}.{b}``, the downsample
    pair -> ``downsample.0/1``."""
    yield "conv", ("conv1",), "conv1"
    yield "bn", ("bn1",), "bn1"
    blocks = sorted((k for k in params if k.startswith("layer")),
                    key=lambda k: tuple(int(n) for n in
                                        k[len("layer"):].split("_block")))
    for name in blocks:
        layer, blk = name[len("layer"):].split("_block")
        tp = f"layer{layer}.{blk}"
        for leaf in ("conv1", "bn1", "conv2", "bn2"):
            yield leaf[:-1] if leaf.startswith("conv") else "bn", \
                (name, leaf), f"{tp}.{leaf}"
        if "downsample_conv" in params[name]:
            yield "conv", (name, "downsample_conv"), f"{tp}.downsample.0"
            yield "bn", (name, "downsample_bn"), f"{tp}.downsample.1"
    yield "conv", ("output_conv",), "output_conv"


def deepcnn_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    return state_dict_from_layers(variables,
                                  deepcnn_layers(variables["params"]))


# PatchGAN: flax Conv_i / BatchNorm_i -> model.<Sequential index>
PATCHGAN_LAYERS = (("conv", ("Conv_0",), "model.0"),
                   ("conv", ("Conv_1",), "model.2"),
                   ("bn", ("BatchNorm_0",), "model.3"),
                   ("conv", ("Conv_2",), "model.5"),
                   ("bn", ("BatchNorm_1",), "model.6"),
                   ("conv", ("Conv_3",), "model.8"),
                   ("bn", ("BatchNorm_2",), "model.9"),
                   ("conv", ("Conv_4",), "model.11"))


def patchgan_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    return state_dict_from_layers(variables, PATCHGAN_LAYERS)


# SimpleDiffusionUNet: the ModelLoader names the JAX converter reads
SIMPLE_BLOCKS = ("inc", "down1", "down2", "up2", "up1")
SIMPLE_LAYERS = (
    (("dense", ("time_mlp1",), "time_mlp.0"),
     ("dense", ("time_mlp2",), "time_mlp.2"))
    + tuple(layer for blk in SIMPLE_BLOCKS for layer in (
        ("conv", (f"{blk}_conv1",), f"{blk}.block.0"),
        ("conv", (f"{blk}_conv2",), f"{blk}.block.2")))
    + (("conv", ("outc",), "outc"),))


def simple_diffusion_state_dict_from_flax(variables: Dict
                                          ) -> Dict[str, torch.Tensor]:
    return state_dict_from_layers(variables, SIMPLE_LAYERS)


# FastDDPMUNet: flax module path -> the reference's (and the port's) name.
# Dense kernels are (I, O), torch Linear weights (O, I); GroupNorm's
# scale/bias are weight/bias.
_FASTDDPM_DENSE = (("time_emb", "Dense_0", "time_emb.fc.0"),
                   ("time_emb", "Dense_1", "time_emb.fc.2"))
DIFFUSION_BLOCKS = ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2",
                    "dec1")


def _fastddpm_layers(params: Dict) -> Layers:
    """Every FastDDPMUNet layer as (kind, flax path, torch prefix)."""
    for outer, inner, prefix in _FASTDDPM_DENSE:
        yield "dense", (outer, inner), prefix
    yield "conv", ("init_conv",), "init_conv"
    for res in DIFFUSION_BLOCKS:
        yield "gn", (res, "norm1"), f"{res}.norm1"
        yield "conv", (res, "conv1"), f"{res}.conv1"
        yield "dense", (res, "time_fc"), f"{res}.time_fc"
        yield "gn", (res, "norm2"), f"{res}.norm2"
        yield "conv", (res, "conv2"), f"{res}.conv2"
        if "skip" in params[res]:
            yield "conv", (res, "skip"), f"{res}.skip"
    for lvl in (3, 2, 1):
        yield "convt", (f"upconv{lvl}",), f"upconv{lvl}"
    yield "gn", ("final_norm",), "final.0"
    yield "conv", ("final_conv",), "final.2"


def fastddpm_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``FastDDPMUNet`` variables -> the port's (= the reference's)
    state dict."""
    return state_dict_from_layers(variables,
                                  _fastddpm_layers(variables["params"]))


def fastddpm_flax_params(model) -> Dict:
    """A port ``FastDDPMUNet`` (or ``DDPMUNet``, ``ADMUNet``, ``DiT``) ->
    the flax param tree (torch tensors on the model's device, float32): the
    layout the serving tables, bundles and ``serve/quant_diffusion.py``
    read.  A top-level tensor (DiT's ``pos_embed`` table) stays a leaf of
    its own name."""
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
        if "." not in key:
            tree[key] = w
            continue
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
        elif w.ndim == 3:  # ADM's 1x1 Conv1d: a 1x1 conv of the maps
            put(path + ("kernel",), conv_kernel_hwio(w[..., None]).contiguous())
        else:
            put(path + ("kernel",), conv_kernel_hwio(w).contiguous())
    return tree
