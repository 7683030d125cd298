#!/usr/bin/env python3
"""Where a full-width float32 train step of the M2 UNet spends its card time.

    python3 tools/train_step_probe.py [--json PATH]

The unet_combined step (features 64, 256^2, batch 4, TF32 off) is timed by
CUDA events (median of 5 after 2 warm-ups) with the UNet's input laid out
as the trainer passes it (an NHWC slice, so the convs see channels_last
memory) and as a contiguous NCHW copy, each with cuDNN's heuristic choice
of algorithm and with ``torch.backends.cudnn.benchmark`` (timed choice).
Beside the step: the UNet forward alone in train and in eval mode, and one
3x3 conv 64 -> 64 at 256^2 forward and backward in both layouts.  The
heuristic, trainer-layout step is profiled once (top kernels by device
time).  Needs one CUDA card; prints the card's name and power limit and one
JSON line (also written to PATH).
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


def conv_table(module, batch, dev):
    """Each conv of the UNet alone, forward and forward + backward, on a
    random input of the shape, dtype and memory layout it gets inside the
    model's forward, at the batch of ``batch`` and at twice that."""
    from mrisr_tpu_torch import fp32_reference

    seen = []

    def hook(mod, args):
        seen.append((mod, args[0].shape, args[0].stride()))

    handles = [(name, m.register_forward_pre_hook(hook))
               for name, m in module.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad(), fp32_reference():
        module.eval()(batch[..., :2])
    for _, h in handles:
        h.remove()
    names = {m: name for name, m in module.named_modules()}
    rows = []
    for mod, shape, stride in seen:
        for n in (shape[0], 2 * shape[0]):
            full = (n,) + tuple(shape[1:])
            # the same strides as inside the model (a channels_last view of
            # an NHWC slice for the first conv), made from a larger buffer
            span = 1 + sum((s - 1) * st for s, st in zip(full, stride))
            buf = torch.randn(span, device=dev)
            x = buf.as_strided(full, stride)

            def fwd():
                with torch.no_grad(), fp32_reference():
                    mod(x)

            def fwd_bwd():
                with fp32_reference():
                    leaf = buf.detach().requires_grad_(True)
                    mod(leaf.as_strided(full, stride)).sum().backward()

            row = {"conv": names[mod], "shape": list(full),
                   "stride": list(stride), "channels_last": x.is_contiguous(
                       memory_format=torch.channels_last),
                   "fwd_ms": median_ms(fwd, reps=3, warmup=1),
                   "fwd_bwd_ms": median_ms(fwd_bwd, reps=3, warmup=1)}
            rows.append(row)
            print(f"  {row['conv']:18s} {str(full):22s} cl={row['channels_last']!s:5s} "
                  f"fwd {row['fwd_ms']:9.3f} ms  fwd+bwd {row['fwd_bwd_ms']:9.3f} ms")
    return rows


def slowest_conv_remedies(module, rows, dev):
    """The slowest conv of the table at its batch-of-``batch`` shape,
    forward + backward under cuDNN's heuristic, ``cudnn.benchmark`` over
    every plan (``benchmark_limit = 0``), cuDNN off (PyTorch's own conv),
    and with a contiguous NCHW input; each output's max |diff| from the
    heuristic's."""
    from mrisr_tpu_torch import fp32_reference

    row = max(rows[::2], key=lambda r: r["fwd_ms"])
    mod = dict(module.named_modules())[row["conv"]]
    full, stride = tuple(row["shape"]), tuple(row["stride"])
    span = 1 + sum((s - 1) * st for s, st in zip(full, stride))
    buf = torch.randn(span, device=dev)
    x_model = buf.as_strided(full, stride)
    x_nchw = x_model.contiguous()
    cudnn = torch.backends.cudnn

    def case(x, benchmark=False, enabled=True):
        def fn():
            prev = cudnn.enabled, cudnn.benchmark
            cudnn.enabled, cudnn.benchmark = enabled, benchmark
            try:
                with fp32_reference():
                    leaf = x.detach().requires_grad_(True)
                    y = mod(leaf)
                    y.sum().backward()
            finally:
                cudnn.enabled, cudnn.benchmark = prev
            return y.detach()
        return fn

    limit = cudnn.benchmark_limit
    cudnn.benchmark_limit = 0
    try:
        cases = {"heuristic": case(x_model),
                 "cudnn.benchmark, every plan": case(x_model, benchmark=True),
                 "cuDNN off": case(x_model, enabled=False),
                 "contiguous NCHW input": case(x_nchw)}
        ref = cases["heuristic"]()
        out = {"conv": row["conv"], "shape": list(full)}
        for name, fn in cases.items():
            ms = median_ms(fn, reps=3, warmup=1)
            diff = float((fn() - ref).abs().max())
            out[name] = {"fwd_bwd_ms": ms, "max_abs_diff": diff}
            print(f"  {row['conv']} {full}: {name:28s} fwd+bwd {ms:9.3f} ms, "
                  f"max |diff| {diff:.3g}")
    finally:
        cudnn.benchmark_limit = limit
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
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
        model=dataclasses.replace(base.model, base_features=FEATURES))
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
    conv = torch.nn.Conv2d(FEATURES, FEATURES, 3, padding=1).to(dev)
    x64 = torch.randn(BATCH, FEATURES, HW, HW, device=dev)
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

    out = {"card": card, "cases": []}
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
    out["convs"] = conv_table(module, batch, dev)
    out["slowest_conv"] = slowest_conv_remedies(module, out["convs"], dev)
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
