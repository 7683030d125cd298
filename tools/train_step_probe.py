#!/usr/bin/env python3
"""Where a full-width train step spends its card time, by conv.

    python3 tools/train_step_probe.py [--dtype bfloat16] [--json PATH]

The unet_combined step (features 64, 256^2, batch 4, TF32 off) is timed by
CUDA events (median of 5 after 2 warm-ups) with the UNet's input laid out
as the trainer passes it (an NHWC slice, so the convs see channels_last
memory) and as a contiguous NCHW copy, each with cuDNN's heuristic choice
of algorithm and with ``torch.backends.cudnn.benchmark`` (timed choice).
The step takes the routes of ``models/conv.py`` around cuDNN; it is timed
once more with no route (cuDNN at every conv).  Beside the step: the UNet
forward alone in train and in eval mode, and one 3x3 conv 64 -> 64 at
256^2 forward and backward in both layouts.  Then every conv of the five
training families' full-width steps (pair UNet, GAN generator and
PatchGAN, DeepCNN, Progressive UNet, Fast-DDPM, simple Fast-DDPM; batch
4) and eval forwards (batch 8), each alone: forward + backward under
cuDNN's heuristic and with cuDNN off (PyTorch's own convolution,
``models/conv.py``), beside its float32 bound (67 TFLOP/s), and the shapes
where cuDNN runs past 10x its bound while its own conv is at least 5x
faster: the shapes ``models/conv.py:CUDNN_FFT_SHAPES`` routes.  The
heuristic, trainer-layout step is profiled once (top kernels by device
time).  ``--dtype bfloat16`` runs all of it in bf16 compute (the models'
``compute_dtype``, as ``train --bf16`` trains), against the bf16 bound
(989 TFLOP/s dense, the H100 SXM data sheet).  Needs one CUDA card; prints
the card's name and power limit and one JSON line (also written to PATH).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HW, FEATURES, BATCH = 256, 64, 4
# dense peak FLOP/s of an H100 SXM by compute dtype (data sheet)
PEAK = {"float32": 67e12, "bfloat16": 989e12}


def median_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def top_kernels(fn, n: int = 6):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    return [{"kernel": e.key[:110], "ms": e.device_time_total / 1e3,
             "count": e.count} for e in rows[:n]]


def family_inputs(dev, n: int, dtype=None):
    """Each training family's full-width module (computing in ``dtype``)
    and the input its step gives it at batch ``n`` (as the trainers lay it
    out: the pair models read an NHWC slice of the (n, H, W, 3) batch)."""
    from mrisr_tpu_torch.models.deepcnn import DeepCNN
    from mrisr_tpu_torch.models.diffusion import (FastDDPMUNet,
                                                  SimpleDiffusionUNet)
    from mrisr_tpu_torch.models.discriminator import PatchGAN
    from mrisr_tpu_torch.models.progressive import ProgressiveUNet
    from mrisr_tpu_torch.models.unet import UNet

    g = torch.Generator(dev).manual_seed(0)
    batch = torch.rand((n, HW, HW, 3), generator=g, device=dev)
    window = torch.rand((n, HW, HW, 5), generator=g, device=dev)
    t = torch.zeros((n,), dtype=torch.int32, device=dev)
    pair = batch[..., :2]
    return {
        "unet_combined": (UNet(FEATURES, dtype=dtype), (pair,)),
        "unet_gan G": (UNet(FEATURES, use_bias=False, dtype=dtype), (pair,)),
        "unet_gan D": (PatchGAN(base_features=FEATURES, dtype=dtype),
                       (batch,)),
        "deepcnn": (DeepCNN(base_features=FEATURES, dtype=dtype), (pair,)),
        "progressive_unet": (ProgressiveUNet(FEATURES, dtype=dtype),
                             (window,)),
        "fastddpm": (FastDDPMUNet(base_features=FEATURES, dtype=dtype),
                     (batch, t)),
        "fastddpm_simple": (SimpleDiffusionUNet(base_features=FEATURES,
                                                dtype=dtype), (batch, t)),
    }


def conv_table(dev, dtype="float32"):
    """Every conv of the five families' full-width train steps (batch 4)
    and eval forwards (batch 8), deduplicated by layer shape and input
    shape and strides: forward + backward (to the input and the weight)
    under cuDNN's heuristic and with cuDNN off (PyTorch's own conv), on a
    random input of the shape, dtype and memory layout it gets in the
    model, beside the bound of the same work in ``dtype`` (forward +
    backward = 3x the forward's FLOPs, at :data:`PEAK`) and the two
    outputs' max |diff|."""
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.models.conv import _cudnn_off, conv2d_no_cudnn

    rows, seen = [], {}
    for n, what in ((BATCH, "train step"), (2 * BATCH, "eval forward")):
        for family, (module, args) in family_inputs(
                dev, n, getattr(torch, dtype)).items():
            module = module.to(dev).train(what == "train step")
            calls = []

            def hook(mod, a):
                calls.append((mod, a[0].shape, a[0].stride()))

            names = {m: name for name, m in module.named_modules()}
            handles = [m.register_forward_pre_hook(hook)
                       for m in module.modules()
                       if isinstance(m, (torch.nn.Conv2d,
                                         torch.nn.ConvTranspose2d))]
            with torch.no_grad(), fp32_reference():
                module(*args)
            for h in handles:
                h.remove()
            for mod, shape, stride in calls:
                key = (type(mod).__name__, tuple(mod.weight.shape),
                       mod.stride, mod.padding, mod.bias is not None,
                       tuple(shape), tuple(stride))
                if key in seen:
                    seen[key]["used_by"].append(f"{family} {names[mod]} "
                                                f"({what})")
                    continue
                row = conv_row(mod, tuple(shape), tuple(stride), dev,
                               fp32_reference, _cudnn_off, conv2d_no_cudnn,
                               dtype)
                row["used_by"] = [f"{family} {names[mod]} ({what})"]
                seen[key] = row
                rows.append(row)
                print(f"  {row['used_by'][0]:44s} {str(row['shape']):22s} "
                      f"cudnn {row['cudnn_ms']:9.3f} ms "
                      f"({row['cudnn_x_bound']:7.1f}x bound) own "
                      f"{row['own_ms']:9.3f} ms bound {row['bound_ms']:.4f} "
                      f"diff {row['max_abs_diff']:.2g}")
            del module
            torch.cuda.empty_cache()
    return rows


def conv_row(mod, full, stride, dev, fp32_reference, cudnn_off,
             conv2d_no_cudnn, dtype="float32"):
    cd = getattr(torch, dtype)
    span = 1 + sum((s - 1) * st for s, st in zip(full, stride))
    buf = torch.randn(span, device=dev, dtype=cd)
    transposed = isinstance(mod, torch.nn.ConvTranspose2d)
    F = torch.nn.functional

    def run(own):
        def fn():
            with fp32_reference():
                leaf = buf.detach().requires_grad_(True)
                x = leaf.as_strided(full, stride)
                w = mod.weight.to(cd)
                b = None if mod.bias is None else mod.bias.to(cd)
                if own and not transposed:
                    y = conv2d_no_cudnn(x, w, b, mod.stride, mod.padding,
                                        mod.dilation)
                elif own:
                    with cudnn_off():
                        y = F.conv_transpose2d(x, w, b, mod.stride)
                else:
                    y = F.conv2d(x, w, b, mod.stride, mod.padding,
                                 mod.dilation) if not transposed else (
                        F.conv_transpose2d(x, w, b, mod.stride))
                if own and transposed:
                    with cudnn_off():
                        y.sum().backward()
                else:
                    y.sum().backward()
            return y.detach()
        return fn

    y_cudnn, y_own = run(False)(), run(True)()
    out_hw = y_cudnn.shape[2] * y_cudnn.shape[3]
    cin = mod.weight.shape[0] if transposed else mod.weight.shape[1]
    cout = mod.weight.shape[1] if transposed else mod.weight.shape[0]
    taps = mod.weight.shape[2] * mod.weight.shape[3]
    flops = 2.0 * full[0] * cout * cin * taps * (
        full[2] * full[3] if transposed else out_hw)
    row = {"layer": type(mod).__name__, "weight": list(mod.weight.shape),
           "conv_stride": list(mod.stride), "shape": list(full),
           "stride": list(stride), "fwd_flop": flops,
           "bound_ms": 3 * flops / PEAK[dtype] * 1e3,
           "cudnn_ms": median_ms(run(False), reps=3, warmup=1),
           "own_ms": median_ms(run(True), reps=3, warmup=1),
           "max_abs_diff": float((y_cudnn - y_own).abs().max().float())}
    row["cudnn_x_bound"] = row["cudnn_ms"] / row["bound_ms"]
    row["own_speedup"] = row["cudnn_ms"] / row["own_ms"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--dtype", default="float32", choices=sorted(PEAK),
                    help="compute dtype of the models and the conv table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_probe: no CUDA device available", file=sys.stderr)
        return 2
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=BATCH, augment=False),
        model=dataclasses.replace(base.model, base_features=FEATURES),
        train=dataclasses.replace(base.train, compute_dtype=args.dtype))
    trainer = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
        cfg.loss.perceptual), device=dev)
    module, state = trainer.state.module, trainer.state
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.random((BATCH, HW, HW, 3), np.float32)).to(
        dev)
    # an NHWC batch, and the same values in NCHW memory behind an NHWC view
    batches = {"trainer layout (NHWC slice)": batch,
               "contiguous NCHW": batch.permute(0, 3, 1, 2).contiguous()
               .permute(0, 2, 3, 1)}
    cd = getattr(torch, args.dtype)
    conv = torch.nn.Conv2d(FEATURES, FEATURES, 3, padding=1).to(dev, cd)
    x64 = torch.randn(BATCH, FEATURES, HW, HW, device=dev, dtype=cd)
    conv_inputs = {"channels_last": x64.contiguous(
        memory_format=torch.channels_last), "contiguous NCHW": x64}

    def step(b):
        return lambda: trainer.train_step(state, b)

    def forward(b, train):
        def fn():
            with fp32_reference(), torch.set_grad_enabled(train):
                module.train(train)(b[..., :2])
        return fn

    def conv_fb(x):
        def fn():
            with fp32_reference():
                xr = x.detach().requires_grad_(True)
                conv(xr).sum().backward()
        return fn

    out = {"card": card, "dtype": args.dtype, "cases": []}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        algo = "cudnn.benchmark" if bench else "heuristic"
        for name, b in batches.items():
            for what, fn in (("train step", step(b)),
                             ("forward, train mode + grad", forward(b, True)),
                             ("forward, eval mode", forward(b, False))):
                ms = median_ms(fn)
                out["cases"].append({"what": what, "input": name,
                                     "algo": algo, "ms": ms})
                print(f"{what:28s} {name:28s} {algo:16s} {ms:9.3f} ms")
        for name, x in conv_inputs.items():
            ms = median_ms(conv_fb(x))
            out["cases"].append({"what": "conv3x3 64->64 fwd+bwd",
                                 "input": name, "algo": algo, "ms": ms})
            print(f"{'conv3x3 64->64 fwd+bwd':28s} {name:28s} {algo:16s} "
                  f"{ms:9.3f} ms")
    torch.backends.cudnn.benchmark = False
    from mrisr_tpu_torch.models import conv as conv_module

    routes = conv_module.route
    conv_module.route = lambda *args: None
    try:
        ms = median_ms(step(batch))
    finally:
        conv_module.route = routes
    out["cases"].append({"what": "train step", "input": "trainer layout "
                         "(NHWC slice)", "algo": "heuristic, no route "
                         "(cuDNN at every conv)", "ms": ms})
    print(f"{'train step, no route':28s} {'trainer layout':28s} "
          f"{'heuristic':16s} {ms:9.3f} ms")
    print(f"every conv of the five families' train steps (batch {BATCH}) "
          f"and eval forwards (batch {2 * BATCH}), fwd+bwd ({card}):")
    out["convs"] = conv_table(dev, args.dtype)
    routed = [r for r in out["convs"]
              if r["cudnn_x_bound"] > 10 and r["own_speedup"] >= 5]
    print("shapes past 10x their bound under cuDNN where its own conv is "
          ">= 5x faster: " + ("; ".join(
              f"{r['used_by']} {r['shape']} w {r['weight']}: cudnn "
              f"{r['cudnn_ms']:.3f} own {r['own_ms']:.3f} ms"
              for r in routed) or "none"))
    out["profile_heuristic_step"] = top_kernels(step(batch))
    print(f"top kernels of one heuristic train step ({card}):")
    for r in out["profile_heuristic_step"]:
        print(f"  {r['ms']:9.3f} ms x{r['count']:<6d} {r['kernel']}")
    print(f"card: {card}")
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
