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


def _reflatten_int8_sites(nested: Dict) -> Dict[str, Dict]:
    """Undo :func:`_unflatten`'s split of '/'-bearing conv-site names
    ("enc2/conv1"): a site is the dict that holds ``w_int8``, re-keyed by
    its joined path."""
    sites: Dict[str, Dict] = {}

    def walk(node, path):
        if "w_int8" in node:
            sites[_SEP.join(path)] = node
            return
        for k, v in node.items():
            walk(v, path + [k])

    walk(nested, [])
    return sites


def _diffusion_apply(params: Dict, meta: Dict, device: torch.device,
                     gn_impl: Optional[str], plain: bool = False):
    """The T-step sampler of a Fast-DDPM bundle: ``cond (B, H, W, 2) ->
    (B, H, W, 1)`` with a generator seeded 0 on every call (the counterpart
    of the JAX package's ``PRNGKey(0)``: serving is deterministic per
    input).  The chain is the meta's ``sampler``: the ancestral one, or
    DDIM over the bundle's grid for a step-distilled student
    (``'ddim_grid'``), which was trained to reproduce its teacher under
    that deterministic sampler.

    ``apply.draw_noise(b, h, w)`` draws, from the same seeded generator and
    in the sampler's order, every value the call on a ``b``-row batch
    draws (x_T and each step's z), and ``apply(cond, noise=...)`` takes
    them (or any rows of them) instead: data-parallel serving draws the
    global batch's noise once and hands each replica its rows, as JAX's
    threefry bits do not depend on the sharding.  ``apply.eps_fn`` is
    the denoiser the chain calls (:class:`FastDDPMForward`)."""
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        sample_ancestral,
    )
    from mrisr_tpu_torch.serve.distill_diffusion import sample_ddim_grid
    from mrisr_tpu_torch.serve.quant_diffusion import FastDDPMForward

    quant = meta["quant"]
    if quant not in ("none", "int8", "int8_deep"):
        raise ValueError(f"diffusion bundles carry quant none/int8/int8_deep, "
                         f"got {quant!r}")
    sched = params["schedule"]
    schedule = DiffusionSchedule(
        betas=sched["betas"].float(), alphas=sched["alphas"].float(),
        alphas_cumprod=sched["alphas_cumprod"].float(),
        timesteps=sched["timesteps"].to(torch.int32))
    combine = meta.get("combine", "first")
    if quant == "none":
        eps_fn = FastDDPMForward(params["params"], device=device)
    else:
        eps_fn = FastDDPMForward(
            params["params"], _reflatten_int8_sites(params["int8"]),
            params.get("timesteps"), gn_impl=gn_impl, device=device,
            plain=plain)
    ddim_grid = meta.get("sampler") == "ddim_grid"
    n_chains = 3 if combine == "mean" else 1  # sample_ancestral's default
    n_z = len(schedule.timesteps) - 1

    @torch.no_grad()
    def apply(cond: torch.Tensor, noise=None) -> torch.Tensor:
        gen = (None if noise is not None else
               torch.Generator(device=device).manual_seed(0))
        cond = cond.to(device, torch.float32)
        if ddim_grid:
            return sample_ddim_grid(eps_fn, cond, gen, schedule, noise=noise)
        return sample_ancestral(eps_fn, cond, gen, schedule, combine=combine,
                                noise=noise)

    @torch.no_grad()
    def draw_noise(b: int, h: int, w: int):
        gen = torch.Generator(device=device).manual_seed(0)

        def draw():
            return torch.randn((b, h, w, 1), generator=gen, device=device,
                               dtype=torch.float32)

        if ddim_grid:
            return draw()
        chains = [(draw(), [draw() for _ in range(n_z)])
                  for _ in range(n_chains)]
        return chains if combine == "mean" else chains[0]

    apply.draw_noise = draw_noise
    apply.eps_fn = eps_fn
    return apply


def _to_numpy(tree: Dict) -> Dict:
    """A tree of tensors (bf16 included) -> float32 numpy leaves."""
    return {k: _to_numpy(v) if isinstance(v, dict) else
            v.detach().float().cpu().numpy() for k, v in tree.items()}


def _require_folded_tree(params: Dict, who: str) -> None:
    """A pair bundle's float tree must be a BN-folded UNet: the forward
    rebuilds ``UNet(use_bn=False)``, which would silently ignore leftover
    BatchNorm parameters."""
    if "enc1" not in params:
        raise ValueError(
            f"{who} expects the UNet-family topology (enc*/dec*/bottleneck "
            "blocks); got keys " + str(sorted(params)[:6]))
    for name, sub in params.items():
        if isinstance(sub, dict) and "BatchNorm_0" in sub:
            raise ValueError(
                f"{who} expects a BN-FOLDED tree (ckpt/fold_bn.py) but "
                f"{name!r} still contains BatchNorm params: fold first")


def _bf16_unet_apply(params: Dict, meta: Dict, device: torch.device):
    """The ``quant='none'`` pair bundle: the BN-folded
    ``UNet(use_bn=False)`` in bf16 compute over the bundle's bf16
    parameters, float32 out."""
    from mrisr_tpu_torch.ckpt.from_jax import unet_state_dict_from_flax
    from mrisr_tpu_torch.models.unet import UNet

    tree = params.get("params", {})
    _require_folded_tree(tree, "make_bundle_apply")
    kernel = tree["enc1"]["Conv_0"]["kernel"]
    module = UNet(features=int(meta["base_features"]), use_bn=False,
                  in_channels=int(kernel.shape[2]),
                  out_channels=int(tree["final"]["kernel"].shape[-1]),
                  dtype=torch.bfloat16)
    # the bf16 values are exact in the float32 parameters, and the
    # forward casts them back to bf16
    module.load_state_dict(unet_state_dict_from_flax(_to_numpy(params)))
    module = module.to(device).eval()

    @torch.no_grad()
    def apply(x: torch.Tensor) -> torch.Tensor:
        return module(x.to(device, torch.float32))

    return apply


def make_bundle_apply(params: Dict, meta: Dict, device: DeviceLike = None,
                      gn_impl: Optional[str] = None, plain: bool = False):
    """The serving forward of a loaded bundle on ``device`` (``None``: the
    card): ``(B, H, W, 2) -> (B, H, W, 1)`` tensors on that device.

    Pair bundles: the one-shot forward; ``quant`` 'int8_fused' (kernels A
    and B), 'int8' (``unet_int8_apply``: kernel A's float epilogue at every
    3x3 conv) or 'none' (the folded UNet in bf16 compute).  Diffusion
    bundles (quant none, int8 or int8_deep): the call runs the whole T-step
    chain of the meta's sampler (ancestral, or ``'ddim_grid'``);
    ``gn_impl`` picks the int8 forward's GroupNorm + SiLU path ('chain',
    or 'fused': K3 at every site, see ``serve/quant_diffusion.py``); a
    'none' bundle takes the device's default.
    ``plain=True`` runs the kernels' plain versions on the card: the
    reference the kernels are held against."""
    device = resolve_device(device)
    if meta.get("kind") == "diffusion":
        return _diffusion_apply(params, meta, device, gn_impl, plain)
    from mrisr_tpu_torch.serve.quant import Int8FusedUNet, Int8UNet

    quant = meta["quant"]
    if quant == "int8_fused":
        return Int8FusedUNet(params, device=device, plain=plain)
    if quant == "int8":
        return Int8UNet(params, device=device, plain=plain)
    if quant == "none":
        return _bf16_unet_apply(params, meta, device)
    raise ValueError(f"pair bundles carry quant none/int8/int8_fused, got "
                     f"{quant!r}")


def export_serving_bundle(
    out_path: str,
    model_name: str = "unet",
    models_dir: str = "models",
    quant: str = "int8_fused",
    calibration_batches=None,
    percentile: Optional[float] = None,
    cfg=None,
    image_size: Tuple[int, int] = (256, 256),
    device: DeviceLike = None,
) -> str:
    """Checkpoint -> (BN-fold) -> calibrate and quantize -> bundle on disk,
    computed on ``device`` (``None``: the card).  A checkpoint is required,
    as in the JAX package.  Pair UNets export quant int8_fused, int8 (the
    same tables) or none (the folded parameters in bf16); the ``fastddpm``
    family, ``fastddpm_pmub``, ``fastddpm_adm`` and ``fastddpm_dit`` export
    their sampler with quant none, int8 or int8_deep."""
    from mrisr_tpu_torch.api import load_model

    loaded = load_model(model_name, models_dir=models_dir,
                        checkpoint="required", cfg=cfg, fold_bn=True,
                        device=device)
    if loaded.name == "fastddpm_simple":
        # M10's SimpleDiffusionUNet is another topology than the two the
        # int8/float sampler walks
        raise ValueError("diffusion bundles cover the fastddpm (M11) family, "
                         "fastddpm_pmub, fastddpm_adm and fastddpm_dit; "
                         "fastddpm_simple has no bundle path")
    if loaded.kind == "diffusion":
        return _export_diffusion_bundle(
            out_path, loaded, quant=quant,
            calibration_batches=calibration_batches, image_size=image_size,
            percentile=percentile)
    if not hasattr(loaded.module, "features"):
        raise ValueError(
            f"serving bundles cover the UNet-family pair models and the "
            f"fastddpm diffusion family; {model_name!r} is "
            f"{type(loaded.module).__name__}, kind={loaded.kind!r}")
    if quant not in ("none", "int8", "int8_fused"):
        raise ValueError(
            f"pair-model bundles support quant none/int8/int8_fused, got "
            f"{quant!r} (int8_deep is the diffusion-sampler path)")
    if quant == "none":
        from mrisr_tpu_torch.ckpt.from_jax import unet_flax_params
        from mrisr_tpu_torch.serve.quant_diffusion import bf16_params

        # the folded tree with every float32 leaf in bf16, as the
        # reference stores it
        return save_bundle(
            out_path, bf16_params(unet_flax_params(loaded.module)),
            model_name=model_name, quant=quant,
            base_features=loaded.module.features, image_size=image_size)
    from mrisr_tpu_torch.serve.quant import calibrate_unet, quantize_unet

    if not calibration_batches:
        raise ValueError("int8 bundles need calibration_batches")
    calib = calibrate_unet(loaded.module, calibration_batches,
                           percentile=percentile)
    return save_bundle(
        out_path, quantize_unet(loaded.module, calib), model_name=model_name,
        quant=quant, base_features=loaded.module.features,
        image_size=image_size,
        calibration=f"{len(calibration_batches)} batches, "
        + _stat_name(percentile))


def _stat_name(percentile: Optional[float]) -> str:
    return "absmax" if percentile is None else f"p{percentile}"


def _export_diffusion_bundle(out_path: str, loaded, *, quant: str,
                             calibration_batches,
                             image_size: Tuple[int, int],
                             percentile: Optional[float] = None) -> str:
    """Fast-DDPM serving bundle: the T-step sampler of ``loaded`` (the
    notebook's FastDDPMUNet, the published DDPM UNet, ADM's UNet or DiT; the
    ancestral chain, or DDIM over the grid of a step-distilled student) as
    one artifact, quant 'none' (bf16), 'int8' (every conv kernel A runs:
    all but the DDPM UNet's stride-2 downsamples) or 'int8_deep' (the
    sites at <= 128^2, ``quant_diffusion.deep_sites``), calibrated on that
    sampler's trajectory."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.serve.quant_diffusion import (
        bf16_params,
        calibrate_fastddpm,
        deep_sites,
        network,
        quantize_fastddpm,
    )

    if quant not in ("none", "int8", "int8_deep"):
        raise ValueError(
            f"diffusion bundles support quant none/int8/int8_deep, got "
            f"{quant!r} (int8_fused is the pair-UNet path)")
    params = fastddpm_flax_params(loaded.module)
    net = network(params)
    sampler = loaded.sampler or "ancestral"
    if quant == "none":
        tree = {"params": bf16_params(params)}
        calib_desc = None
    else:
        if not calibration_batches:
            raise ValueError("int8 bundles need calibration_batches")
        gen = torch.Generator(device=loaded.device).manual_seed(0)
        ranges = calibrate_fastddpm(
            {"params": params}, loaded.schedule, calibration_batches, gen,
            percentile=percentile, sampler=sampler)
        tree = quantize_fastddpm(
            {"params": params}, ranges,
            only=deep_sites(params) if quant == "int8_deep" else None)
        calib_desc = (f"{len(calibration_batches)} cond batches, trajectory "
                      + _stat_name(percentile))
    # ship the exact sampling tables: rebuilding them from a config at load
    # time could drift from what the model was evaluated with
    sched = loaded.schedule
    tree["schedule"] = {"betas": sched.betas, "alphas": sched.alphas,
                        "alphas_cumprod": sched.alphas_cumprod,
                        "timesteps": sched.timesteps}
    return save_bundle(
        out_path, tree, model_name=loaded.name, quant=quant,
        base_features=net.base_features(params), image_size=image_size,
        calibration=calib_desc,
        extra={"kind": "diffusion", "time_dim": net.time_dim(params),
               "combine": "first", "sampler": sampler})


def engine_from_bundle(path: str, batch_size: int = 128,
                       device: DeviceLike = None,
                       gn_impl: Optional[str] = None,
                       data_parallel: bool = False, devices=None,
                       **engine_kwargs):
    """One call serving: bundle dir -> running InferenceEngine on
    ``device`` (``None``: the card); ``gn_impl`` goes to
    :func:`make_bundle_apply`.

    ``data_parallel=True`` splits each micro-batch over ``devices``
    (``None``: every visible card), one replica of the forward a device
    (``engine.data_parallel_apply``), for pair and diffusion bundles
    alike; ``batch_size`` must divide by the device count."""
    from mrisr_tpu_torch.serve.engine import (
        InferenceEngine,
        data_parallel_apply,
    )

    device = resolve_device(device)
    params, meta = load_bundle(path)
    h, w = meta["image_size"]

    def make(d):
        return make_bundle_apply(params, meta, d, gn_impl=gn_impl)

    apply_fn = (data_parallel_apply(make, batch_size, devices, device)
                if data_parallel else make(device))
    return InferenceEngine(
        apply_fn, batch_size=batch_size, input_shape=(h, w, 2),
        device=device, **engine_kwargs,
    )
