#!/usr/bin/env python3
"""Digests of what the Fast-DDPM serving path computes, so that a change of
its structure can be held to another checkout's bits.

    python3 tools/fastddpm_digest.py [--root DIR] [--card]

DIR (default: this checkout) is the checkout whose ``mrisr_tpu_torch`` runs.

Without ``--card``, on the CPU at small widths (the notebook FastDDPMUNet
at base 8 on 16^2, the DDPM UNet at ch 32 on 64^2, seeded as
``tests/test_torch_port_time_shift.py`` seeds them), for each network: the
SHA-256 of ``FastDDPMForward``'s bf16 output for gn_impl 'chain' and
'fused' with no int8 site, every int8 site (``quantize_fastddpm``'s
``only=None``) and ``int8_deep``; of ``calibrate_fastddpm``'s tables over a
2-step trajectory; of both ``quantize_fastddpm`` trees; and of the ordered
names, ids and parents of the spans one ``int8_deep`` call records under a
profiler, for each gn_impl.

With ``--card`` (one CUDA card; the ``fastddpm``, ``fastddpm_pmub``,
``fastddpm_adm`` and ``fastddpm_dit`` presets' networks at full width, the
registry's seeded init, 256^2): one ``int8_deep`` sampler call of each (the
preset's schedule, batch 32, 'fused', calibrated on 4 of the conds), run
twice: the digests of its output and of the calibration tables, and the
launches of kernels A, B and K3 (and K3's shifted launches), of the
quantizer kernel and of kernel E (all, and with a residual), and kernel A's
GEMM-form launches, where DIR's package has them, in one call.  Then the
pair UNet at features 64 served ``int8_fused`` (BN folded, calibrated on 8
of the pairs): the digest of one forward of 32 seeded 256^2 pairs, twice.

Prints one JSON line; two checkouts compute the same when their lines are
equal.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(obj) -> str:
    """SHA-256 of a tensor, an array or a (nested) dict of them: dtypes,
    shapes and bytes, keys in sorted order."""
    import numpy as np
    import torch

    h = hashlib.sha256()

    def feed(o):
        if isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                feed(o[k])
            return
        t = (o if isinstance(o, torch.Tensor) else
             torch.from_numpy(np.asarray(o))).detach().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy())

    feed(obj)
    return h.hexdigest()[:16]


def spans_of(call):
    """The spans ``call()`` records under a CPU profiler, in the order they
    ended: (name, ids, the index of the span open around it or -1)."""
    from torch.profiler import ProfilerActivity, profile

    from mrisr_tpu_torch.utils.profiling import RECORDER

    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    spans = RECORDER.spans()
    RECORDER.clear()
    index = {s.key: i for i, s in enumerate(spans)}
    return [(s.name, sorted(s.ids.items()), index.get(s.parent, -1))
            for s in spans]


def cpu_digests() -> dict:
    import torch

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        FastDDPMForward,
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.set_num_threads(2)
    with torch.random.fork_rng():
        torch.manual_seed(20)
        nets = {"notebook": (FastDDPMUNet(base_features=8, time_dim=16), 16),
                "ddpm": (DDPMUNet(base_features=32), 64)}
    sched = DiffusionSchedule.create(1000, 2, "linear", "linspace")
    out = {}
    for net, (model, hw) in nets.items():
        params = fastddpm_flax_params(model)
        g = torch.Generator().manual_seed(hw)
        x = torch.randn((2, hw, hw, 3), generator=g)
        t = torch.tensor([999, 400])
        cond = torch.randn((2, hw, hw, 2), generator=g)
        calib = calibrate_fastddpm({"params": params}, sched, [cond])
        out[f"{net}.calibration"] = digest(calib)
        tables = {"all": quantize_fastddpm({"params": params}, calib),
                  "deep": quantize_fastddpm({"params": params}, calib,
                                            only=deep_sites(params))}
        for only, q in tables.items():
            out[f"{net}.quantize.{only}"] = digest(q)
        for gn_impl in ("chain", "fused"):
            fwd = FastDDPMForward(params, gn_impl=gn_impl, device="cpu")
            out[f"{net}.{gn_impl}.none"] = digest(fwd(x, t))
            for only, q in tables.items():
                fwd = int8_forward(q, gn_impl=gn_impl, device="cpu")
                out[f"{net}.{gn_impl}.{only}"] = digest(fwd(x, t))
            fwd = int8_forward(tables["deep"], gn_impl=gn_impl, device="cpu")
            spans = spans_of(lambda: fwd(x, t))
            out[f"{net}.{gn_impl}.spans"] = (
                len(spans), hashlib.sha256(json.dumps(spans).encode())
                .hexdigest()[:16])
    return out


def card_digests() -> dict:
    import importlib.util

    import torch

    from mrisr_tpu_torch import _build
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        sample_ancestral,
    )
    from mrisr_tpu_torch.models.registry import init_model
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    dev = torch.device("cuda")
    _build.build()
    counters = {"conv2d_int8.launches": (conv2d_int8, "launches"),
                "upconv2x2_int8.launches": (upconv2x2_int8, "launches"),
                "groupnorm_silu.launches": (groupnorm_silu, "launches"),
                "groupnorm_silu.launches_shift": (groupnorm_silu,
                                                  "launches_shift")}
    if importlib.util.find_spec("mrisr_tpu_torch.ops.quantize"):
        from mrisr_tpu_torch.ops.quantize import quantize_int8

        counters["quantize_int8.launches"] = (quantize_int8, "launches")
    if hasattr(conv2d_int8, "launches_gemm"):
        counters["conv2d_int8.launches_gemm"] = (conv2d_int8, "launches_gemm")
    if importlib.util.find_spec("mrisr_tpu_torch.ops.bias_residual"):
        from mrisr_tpu_torch.ops.bias_residual import bias_residual

        for a in ("launches", "launches_residual"):
            counters[f"bias_residual.{a}"] = (bias_residual, a)
    out = {"card": torch.cuda.get_device_name(0)}
    for name in ("fastddpm", "fastddpm_pmub", "fastddpm_adm", "fastddpm_dit"):
        mcfg = PRESETS[name].model
        model, _ = init_model(name, mcfg, seed=6)
        params = fastddpm_flax_params(model.to(dev))
        sched = DiffusionSchedule.create(
            mcfg.num_timesteps, mcfg.num_inference_steps, mcfg.beta_schedule,
            mcfg.timestep_selection)
        cond = torch.rand((32, 256, 256, 2), device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
        calib = calibrate_fastddpm({"params": params}, sched, [cond[:4]],
                                   torch.Generator(dev).manual_seed(0))
        out[f"{name}.calibration"] = digest(calib)
        q = quantize_fastddpm({"params": params}, calib,
                              only=deep_sites(params))
        fwd = int8_forward(q, gn_impl="fused", device=dev)
        for run in (0, 1):
            before = {k: getattr(f, a) for k, (f, a) in counters.items()}
            gen = torch.Generator(dev).manual_seed(0)
            y = sample_ancestral(fwd, cond, gen, sched)
            torch.cuda.synchronize()
            out[f"{name}.sample.{run}"] = digest(y)
            out[f"{name}.finite"] = bool(torch.isfinite(y).all())
            out[f"{name}.launches.{run}"] = {
                k: getattr(f, a) - before[k]
                for k, (f, a) in counters.items()}
        del model, params, calib, q, fwd, y
    from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
    from mrisr_tpu_torch.models import UNet
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet,
        calibrate_unet,
        quantize_unet,
    )

    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(6)
        folded = fold_unet_batchnorm(UNet(features=64).eval().to(dev))
    x = torch.rand((32, 256, 256, 2), device=dev,
                   generator=torch.Generator(dev).manual_seed(3))
    fwd = Int8FusedUNet(quantize_unet(folded, calibrate_unet(folded, [x[:8]])),
                        "shared", device=dev)
    for run in (0, 1):
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        y = fwd(x)
        torch.cuda.synchronize()
        out[f"unet_m2.forward.{run}"] = digest(y)
        out[f"unet_m2.launches.{run}"] = {
            k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import mrisr_tpu_torch

    if not mrisr_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {mrisr_tpu_torch.__file__}, not from "
                           f"{root}")
    if args.card and not torch.cuda.is_available():
        print("fastddpm_digest: no CUDA device available", file=sys.stderr)
        return 2
    out = card_digests() if args.card else cpu_digests()
    print(json.dumps({"root": root, **out}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
