#!/usr/bin/env python3
"""Device and host ms of one Fast-DDPM sampler call (10 ancestral steps,
batch 8, 256^2) of a seeded full-width model, quantized int8_deep (GroupNorm
'fused' through K3 and 'chain'), and of its bf16 float forward.

    python3 tools/sampler_time.py [--root DIR] [--label NAME]

DIR (default: this checkout) is a checkout whose ``mrisr_tpu_torch`` package
is timed: its forward, sampler, calibration and kernels (built into DIR's
own build directory).  The model (``chip_smoke.seeded_fastddpm(6)``), the
conds and the timing loop (``cuda_ms``: calls queued behind a device-side
sleep, the median of 5) are this checkout's.  The int8 tables come from a
calibration on one seeded batch of conds.  Two versions compare in one run
on one card when the script runs once for each, in turns.  Needs one CUDA
card.  Prints the card and one JSON line: {"label", "root", "card",
"ms": {setup: device ms a call}, "host_ms": {setup: host ms a call, the
least of 3 synchronized calls}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, HW, REPS = 8, 256, 5


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("sampler_time: no CUDA device available", file=sys.stderr)
        return 2
    from mrisr_tpu_torch import _build
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.diffusion import (DiffusionSchedule,
                                                  sample_ancestral)
    from mrisr_tpu_torch.serve.quant_diffusion import (
        DEEP_SITES, FastDDPMForward, calibrate_fastddpm, int8_forward,
        quantize_fastddpm)

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.build()
    params = fastddpm_flax_params(cs.seeded_fastddpm(6).to(dev))
    sched = DiffusionSchedule.create(1000, 10, "cosine")
    g = torch.Generator(device=dev).manual_seed(3)
    cond = torch.rand((BATCH, HW, HW, 2), generator=g, device=dev)
    ranges = calibrate_fastddpm(
        {"params": params}, sched, [cond],
        torch.Generator(device=dev).manual_seed(0))
    tree = quantize_fastddpm({"params": params}, ranges, only=DEEP_SITES)
    setups = {
        "int8_deep fused": int8_forward(tree, gn_impl="fused", device=dev),
        "int8_deep chain": int8_forward(tree, gn_impl="chain", device=dev),
        "bf16": FastDDPMForward(tree["params"], device=dev)}
    ms, host_ms = {}, {}
    for label, fwd in setups.items():
        def call():
            gen = torch.Generator(device=dev).manual_seed(0)
            return sample_ancestral(fwd, cond, gen, sched)

        ms[label] = cs.cuda_ms(call, reps=REPS)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        host_ms[label] = min(walls)
    print(f"card: {card}")
    print(json.dumps({"label": args.label, "root": root, "card": card,
                      "ms": ms, "host_ms": host_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
