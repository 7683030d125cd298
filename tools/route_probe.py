#!/usr/bin/env python3
"""How the conv routes of ``models/conv.py`` move a full-width float32 train
step's exactness and time on the card.

    python3 tools/route_probe.py [--json PATH]

For the ``fastddpm`` and ``unet_combined`` presets (width 64, 256^2, batch
4, TF32 off, augmentation off, one batch of a synthetic 8 x 12 store): one
train step on the CPU in float64 (the reference) and in float32, then on
the card in float32 under each route set: no route (cuDNN at every conv),
the 'fft' route alone, both routes (the port's), and every conv around
cuDNN.  For each: the worst gradient rel-L2 against the float64 step (and
its tensor) and the step's device time (CUDA events, median of 5 after 2
warm-ups).  The Fast-DDPM step takes fixed draws (the same timesteps and
noise everywhere).  Needs one CUDA card; prints the card's name and power
limit and one JSON line (also written to PATH).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the card line, timing, trainers)

VARIANTS = ("no route", "fft only", "port (fft + small map)", "every conv")


def route_for(variant, default):
    if variant == "no route":
        return lambda *args: None
    if variant == "fft only":
        return lambda shape, conv, recorded: default(shape, conv, False)
    if variant == "every conv":
        return lambda *args: "every"
    return default


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("route_probe: no CUDA device available", file=sys.stderr)
        return 2
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.models import conv as conv_module

    card = cs.card_line()
    dev = torch.device("cuda")
    out = {"card": card, "presets": {}}
    with tempfile.TemporaryDirectory() as work:
        cli.main(["synth", os.path.join(work, "s"), "--patients", "8",
                  "--slices", "12", "--size", "256"])
        store = VolumeStore.open(os.path.join(work, "s"))
        for preset in ("fastddpm", "unet_combined"):
            base = PRESETS[preset]
            cfg = base.replace(data=dataclasses.replace(
                base.data, image_size=(256, 256), batch_size=4,
                augment=False))
            batch = next(iter(build_loader(store, "train", cfg.data,
                                           device="cpu")))
            g = torch.Generator().manual_seed(1)
            t_idx = torch.randint(0, cfg.model.num_inference_steps, (4,),
                                  generator=g)
            eps = torch.randn(batch[..., 2:3].shape, generator=g)

            def step(device, dtype):
                tr, _ = cs.make_trainer(preset, cfg, device, dtype)
                x = batch.to(device, dtype)
                if cfg.loss.kind == "diffusion":
                    ti, ep = t_idx.to(device), eps.to(device, dtype)
                    fn = lambda: tr.train_step.train_on(  # noqa: E731
                        tr.state, x, ti, ep)
                else:
                    fn = lambda: tr.train_step(tr.state, x)  # noqa: E731
                return tr, fn

            ref, fn = step("cpu", torch.float64)
            fn()
            ref = ref.state.module
            cpu, fn = step("cpu", torch.float32)
            fn()
            errs = cs.grad_errors(cpu.state.module, ref)
            worst = max(errs, key=errs.get)
            rows = {"CPU float32": {"worst": errs[worst], "at": worst}}
            default = conv_module.route
            for variant in VARIANTS:
                conv_module.route = route_for(variant, default)
                try:
                    tr, fn = step(dev, torch.float32)
                    fn()
                    errs = cs.grad_errors(tr.state.module, ref)
                    timed, tfn = step(dev, torch.float32)
                    ms = cs.cuda_ms(tfn, reps=5, warmup=2)
                finally:
                    conv_module.route = default
                worst = max(errs, key=errs.get)
                rows[variant] = {"worst": errs[worst], "at": worst,
                                 "step_ms": ms}
                del tr, timed
                torch.cuda.empty_cache()
            out["presets"][preset] = rows
            for name, r in rows.items():
                print(f"{preset:14s} {name:24s} worst gradient rel-L2 "
                      f"{r['worst']:.3g} ({r['at']})"
                      + (f", step {r['step_ms']:.3f} ms" if "step_ms" in r
                         else "") + f" ({card})")
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
