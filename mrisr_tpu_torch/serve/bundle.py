"""Serving bundles (counterpart: ``mrisr_tpu/serve/bundle.py``).

A bundle is a directory with ``arrays.npz`` (the serving tables flattened
with '/'-joined keys; bf16 stored as uint16 bit patterns, listed in
``meta.json``'s ``bf16_keys``) and ``meta.json``.  The format is the
reference's, so a bundle either package writes serves in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mrisr_tpu_torch.device import DeviceLike, resolve_device

_SEP = "/"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = torch.as_tensor(v)
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_bundle(
    path: str,
    params: Dict,
    *,
    model_name: str,
    quant: str,
    base_features: int,
    image_size: Tuple[int, int] = (256, 256),
    calibration: Optional[str] = None,
    extra: Optional[Dict] = None,
) -> str:
    """Write a serving bundle directory; returns its path.  params: the
    ``quantize_unet`` tables (tensors)."""
    os.makedirs(path, exist_ok=True)
    arrays, bf16_keys = {}, []
    for k, v in _flatten(params).items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            arrays[k] = v.view(torch.int16).numpy().view(np.uint16)
            bf16_keys.append(k)
        else:
            arrays[k] = v.numpy()
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta = {
        "format_version": 1,
        "model_name": model_name,
        "quant": quant,
        "base_features": int(base_features),
        "image_size": list(image_size),
        "calibration": calibration,
        "bf16_keys": bf16_keys,
        **(extra or {}),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_bundle(path: str) -> Tuple[Dict, Dict]:
    """Read a bundle -> (tree of CPU tensors, meta dict)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    bf16 = set(meta.get("bf16_keys", ()))
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k in z.files:
            v = z[k]
            if k in bf16:
                flat[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(v)
    return _unflatten(flat), meta


def make_bundle_apply(params: Dict, meta: Dict, device: DeviceLike = None):
    """The serving forward of a loaded bundle on ``device`` (``None``: the
    card): ``(B, H, W, 2) -> (B, H, W, 1)`` tensors on that device.

    Only ``quant='int8_fused'`` pair-UNet bundles are ported so far; the
    other modes raise (ROADMAP.md, Queue 1 items 8 and 12-13)."""
    device = resolve_device(device)
    if meta.get("kind") == "diffusion":
        raise NotImplementedError(
            "diffusion bundles are not ported yet (ROADMAP.md, Queue 1 "
            "items 12-13)")
    if meta["quant"] != "int8_fused":
        raise NotImplementedError(
            f"bundle quant {meta['quant']!r} is not ported yet; the port "
            "serves 'int8_fused' (ROADMAP.md, Queue 1 item 8)")
    from mrisr_tpu_torch.serve.quant import Int8FusedUNet

    return Int8FusedUNet(params, device=device)


def engine_from_bundle(path: str, batch_size: int = 128,
                       device: DeviceLike = None, **engine_kwargs):
    """One call serving: bundle dir -> running InferenceEngine on
    ``device`` (``None``: the card)."""
    from mrisr_tpu_torch.serve.engine import InferenceEngine

    device = resolve_device(device)
    params, meta = load_bundle(path)
    h, w = meta["image_size"]
    return InferenceEngine(
        make_bundle_apply(params, meta, device), batch_size=batch_size,
        input_shape=(h, w, 2), device=device, **engine_kwargs,
    )
