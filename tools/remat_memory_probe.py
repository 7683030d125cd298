#!/usr/bin/env python3
"""What one full-width float32 train step holds at its memory peak, plain
and with remat (``ModelConfig.remat``), on the card.

    python3 tools/remat_memory_probe.py [--batch 32] [--json PATH]

The ``unet_combined`` preset (width 64, 256^2, TF32 off, random batches):
for each of plain and remat, after a warm-up step at batch 4, one step at
``--batch`` with ``torch.cuda.memory._record_memory_history`` on.  From the
trace: the peak of the bytes allocated, and the five largest blocks alive
at the peak with the innermost frames of the port (or of torch, where the
port has none) that allocated them.  Then the same step with cuDNN off
(PyTorch's own convolution).  Last, each 3x3/1x1 conv of the
UNet alone at its input shape at ``--batch``, forward + backward as the
port runs it (``models/conv.py``'s route, else cuDNN's heuristic) and with
cuDNN off (PyTorch's own convolution): the memory it allocates beyond its
input and output (GB), its device ms and the largest difference of the two
outputs.  Needs one CUDA card; prints the card's name and power limit and
one JSON line (also written to PATH).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the card line)

MODES = ("plain", "remat")


def trainer(remat: bool, dev):
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(cs.HW, cs.HW),
                                 batch_size=4, augment=False),
        model=dataclasses.replace(base.model, base_features=cs.FEATURES,
                                  remat=remat))
    tr = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
        cfg.loss.perceptual), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    tr.train_step(tr.state, torch.rand((4, cs.HW, cs.HW, 3), generator=g,
                                       device=dev))
    return tr, g


def peak_step(tr, g, batch: int, dev) -> float:
    """One step at ``batch``: max_memory_allocated in GB."""
    x = torch.rand((batch, cs.HW, cs.HW, 3), generator=g, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(tr.state, x)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def where(frames) -> str:
    """The innermost frame of the repo's code, else the innermost one."""
    for f in frames:
        if ROOT in f.get("filename", "") and "tools/" not in f["filename"]:
            return (f"{os.path.relpath(f['filename'], ROOT)}:{f['line']} "
                    f"{f['name']}")
    f = frames[0] if frames else {"filename": "?", "line": 0, "name": "?"}
    return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"


def traced_peak(tr, g, batch: int, dev) -> dict:
    """One step at ``batch`` under the allocator's history: the peak of
    the live bytes and the five largest blocks live at it."""
    torch.cuda.memory._record_memory_history(stacks="python",
                                            max_entries=2_000_000)
    peak_step(tr, g, batch, dev)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, total, best, at_best = {}, 0, 0, {}
    for trace in snap["device_traces"]:
        for e in trace:
            if e["action"] == "alloc":
                live[e["addr"]] = (e["size"], e.get("frames", []))
                total += e["size"]
                if total > best:
                    best, at_best = total, dict(live)
            elif e["action"] in ("free_requested", "free_completed"):
                if e["addr"] in live:
                    total -= live.pop(e["addr"])[0]
    top = sorted(at_best.values(), key=lambda v: -v[0])[:5]
    return {"live_gb_at_peak_of_trace": best / 1e9,
            "largest": [{"gb": s / 1e9, "where": where(fr)} for s, fr in top]}


def conv_sites(batch: int, dev):
    """Each Conv2d of the full-width UNet alone at its input shape at
    ``batch`` (float32, TF32 off): (name, shape, extra GB, ms) as the port
    runs it and with cuDNN off, and the max |difference| of the outputs."""
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.models import UNet
    from mrisr_tpu_torch.models.conv import Conv2d, conv2d_no_cudnn

    model = UNet(features=cs.FEATURES).to(dev)
    shapes = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d):
            m.register_forward_pre_hook(
                lambda m, i, name=name: shapes.update({name: i[0].shape}))
    with torch.no_grad():
        model.eval()(torch.zeros((1, cs.HW, cs.HW, 2), device=dev))
    rows = []
    g = torch.Generator(device=dev).manual_seed(1)
    for name, m in model.named_modules():
        if name not in shapes:
            continue
        x = torch.randn((batch, *shapes[name][1:]), generator=g, device=dev
                        ).contiguous(memory_format=torch.channels_last)
        x.requires_grad_(True)
        row = {"name": name, "shape": list(x.shape),
               "out_channels": m.out_channels}
        outs = {}
        for label, fn in (("port", lambda: m(x)), ("own", lambda: (
                conv2d_no_cudnn(x, m.weight, m.bias, m.stride, m.padding,
                                m.dilation)))):
            def step():
                with fp32_reference():
                    y = fn()
                    y.backward(torch.ones_like(y))
                return y
            step()  # warm-up
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            y = step()
            torch.cuda.synchronize()
            out_bytes = y.numel() * 4
            row[f"{label}_extra_gb"] = (torch.cuda.max_memory_allocated()
                                        - before - 2 * out_bytes) / 1e9
            outs[label] = y.detach()
            del y
            row[f"{label}_ms"] = cs.cuda_ms(step, reps=3, warmup=1)
        row["max_abs_diff"] = float((outs["port"] - outs["own"]).abs().max())
        rows.append(row)
        del x, outs
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("remat_memory_probe: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    out = {"card": card, "batch": args.batch, "modes": {}}
    for mode in MODES:
        tr, g = trainer(mode == "remat", dev)
        row = {"peak_gb": peak_step(tr, g, args.batch, dev),
               **traced_peak(tr, g, args.batch, dev)}
        torch.backends.cudnn.enabled = False
        row["peak_gb_cudnn_off"] = peak_step(tr, g, args.batch, dev)
        torch.backends.cudnn.enabled = True
        out["modes"][mode] = row
        print(f"{mode} at batch {args.batch}: peak {row['peak_gb']:.3f} GB, "
              f"{row['peak_gb_cudnn_off']:.3f} GB with cuDNN off; largest "
              f"live at the peak: " + "; ".join(
                  f"{b['gb']:.3f} GB {b['where']}" for b in row["largest"])
              + f" ({card})")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    out["sites"] = conv_sites(args.batch, dev)
    for r in out["sites"]:
        print(f"{r['name']} {r['shape']} -> {r['out_channels']}: extra "
              f"{r['port_extra_gb']:.3f} GB port, {r['own_extra_gb']:.3f} "
              f"GB own; fwd+bwd {r['port_ms']:.3f} ms port, "
              f"{r['own_ms']:.3f} own; max |diff| {r['max_abs_diff']:.3g} "
              f"({card})")
    print(json.dumps(out))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
