#!/usr/bin/env python3
"""Where kernels K3 (GroupNorm+SiLU+int8) and K1 (fused SSIM) spend their
time on one CUDA card.

    python3 tools/k3_k1_probe.py [--json build/probe/rows.json] [--only k3|k1]

K3: ``csrc/groupnorm_silu.cu`` built with ``-DGN_PHASE_CLOCKS`` at 1024
threads a block (the port's) and at 512 (block 0
records its SM clock at the start of each pass and after each phase) and
run at the 10 int8_deep sites at batch 8 (int8 out, bf16 in, after a 64
MiB L2 scrub): microseconds in staging and sums (overlapped), the barrier,
the fold and the apply, summed over the passes, at the SM clock nvidia-smi
reads, beside the launch's device time.

K1: ``csrc/ssim.cu`` built with 4, 2 or 1 warps a block (its registers
decide how many blocks an SM holds) and timed at N = 64 and 174 (256^2) at
the plan's bands and a few others.
Builds go to ``build/probe/`` (git-ignored)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mrisr_tpu_torch import _build  # noqa: E402
from mrisr_tpu_torch.device import sm_count  # noqa: E402

PROBE = os.path.join(ROOT, "build", "probe")
PHASES = ("stage+sums", "barrier", "fold", "apply")


def build(name: str, src: str, flags=()) -> ctypes.CDLL:
    os.makedirs(PROBE, exist_ok=True)
    cu = os.path.join(PROBE, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    out = os.path.join(PROBE, f"{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
           str(_build.CSRC), "-o", out, cu]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = re.findall(r"Used (\d+) registers", r.stdout + r.stderr)
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.registers = sorted({int(r) for r in regs})
    return lib


def sm_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return float(r.stdout.split()[0])


# (threads a block, groups a thread at once in the apply)
VARIANTS = ((1024, 4), (512, 4))


def k3(dev):
    src = (_build.CSRC / "groupnorm_silu.cu").read_text()
    hooks = ("constexpr int THREADS = 1024;", "constexpr int ILP = 4;")
    assert all(h in src for h in hooks), "csrc/groupnorm_silu.cu: hooks moved"
    rows = []
    for threads, ilp in VARIANTS:
        rows += k3_variant(dev, src.replace(
            hooks[0], f"constexpr int THREADS = {threads};").replace(
            hooks[1], f"constexpr int ILP = {ilp};"), threads, ilp)
    return rows


def k3_variant(dev, src, threads, ilp):
    from mrisr_tpu_torch.ops import groupnorm

    lib = build(f"gn_t{threads}_i{ilp}", src, ["-DGN_PHASE_CLOCKS"])
    lib.groupnorm_silu_marks.argtypes = [ctypes.c_void_p]
    real, real_threads = _build.library, groupnorm.THREADS
    _build.library = lambda name: lib if name == "groupnorm_silu" else real(
        name)
    groupnorm.THREADS = threads  # the plan's shared-memory reserve
    g = torch.Generator(device=dev).manual_seed(5)
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    rows = []
    try:
        for name, h, c in chip_smoke.diffusion_gn_sites():
            x = (3 * torch.randn((chip_smoke.BATCH, h, h, c), generator=g,
                                 device=dev) + 0.5).to(torch.bfloat16)
            gamma = torch.ones(c, device=dev)
            beta = torch.zeros(c, device=dev)
            scale = torch.full((1,), 0.02, device=dev)

            def run():
                return groupnorm.groupnorm_silu(x, gamma, beta,
                                                num_groups=c // 4,
                                                quant_scale=scale)
            ms = chip_smoke.cuda_ms(run, reps=20, flush=scrub.zero_)
            scrub.zero_()
            run()
            torch.cuda.synchronize()
            mhz = sm_mhz()
            marks = np.zeros((64, 5), np.int64)
            _build.check(lib.groupnorm_silu_marks(marks.ctypes.data),
                         "marks")
            p = groupnorm.plan(chip_smoke.BATCH, h * h, c, 2,
                               sm_count(dev))
            m = marks[:p.passes].astype(np.float64) / mhz  # us
            phases = {k: float(np.sum(m[:, i + 1] - m[:, i]))
                      for i, k in enumerate(PHASES)}
            rows.append({"threads": threads, "ilp": ilp,
                         "registers": lib.registers,
                         "site": name, "H": h, "C": c, "passes": p.passes,
                         "spp": p.spp, "ms": ms, "sm_mhz": mhz,
                         "us_by_phase": phases,
                         "us_in_passes": float(m[-1, 4] - m[0, 0])})
            print(f"K3 {threads}x{ilp} {name:18s} {p.passes} x {p.spp}: "
                  f"{ms * 1e3:7.1f} us "
                  f"launch, {rows[-1]['us_in_passes']:7.1f} us in passes; "
                  + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
                  + f" (SM {mhz:.0f} MHz)")
    finally:
        _build.library, groupnorm.THREADS = real, real_threads
    total = sum(r["ms"] for r in rows) * 1e3
    apply = sum(r["us_by_phase"]["apply"] for r in rows)
    print(f"K3 {threads} threads, ILP {ilp} (registers {lib.registers}): "
          f"{total:.1f} us over the 10 sites, apply {apply:.1f} us")
    return rows


def k1(dev):
    from mrisr_tpu_torch.ops import ssim_fused

    src = (_build.CSRC / "ssim.cu").read_text()
    hook = "constexpr int WARPS = 4;"
    assert hook in src, "csrc/ssim.cu: the probe's hook moved"
    g = torch.Generator(device=dev).manual_seed(7)
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    real = ssim_fused.WARPS
    rows = []
    for warps in (4, 2, 1):
        lib = build(f"ssim_w{warps}", src.replace(
            hook, f"constexpr int WARPS = {warps};"))
        per_sm = lib.ssim_blocks_per_sm(7)
        ssim_fused.WARPS = warps  # the plan's wave size
        try:
            for n in (64, 174):
                x = torch.rand((n, 256, 256), generator=g, device=dev)
                y = (x + 0.2 * torch.randn(x.shape, generator=g, device=dev)
                     ).clamp(0, 1)
                out = torch.empty(n, device=dev)
                plan = ssim_fused.plan(n, 256, 256, 7,
                                       sm_count(dev),
                                       per_sm)
                for bands in sorted({plan.bands, 3, 4, 6, 8}):
                    band = -(-250 // bands)
                    bands = -(-250 // band)
                    part = torch.empty((n, plan.strips * bands), device=dev)
                    stream = torch.cuda.current_stream().cuda_stream

                    def run():
                        _build.check(lib.ssim_launch(
                            x.data_ptr(), y.data_ptr(), part.data_ptr(),
                            out.data_ptr(), n, 256, 256, 7, plan.strips,
                            bands, band, 1e-4, 9e-4, stream), "ssim")
                    ms = chip_smoke.cuda_ms(run, reps=20, flush=scrub.zero_)
                    rows.append({"warps": warps, "registers": lib.registers,
                                 "blocks_per_sm": per_sm, "N": n,
                                 "bands": bands, "band": band,
                                 "planned": bands == plan.bands, "ms": ms})
                    print(f"K1 {warps} warps a block ({per_sm} blocks an SM "
                          f"at win 7, registers {lib.registers}) N {n:3d} "
                          f"{plan.strips} strips x {bands:2d} bands of "
                          f"{band:3d} rows: {ms * 1e3:7.1f} us"
                          + (" (plan)" if bands == plan.bands else ""))
        finally:
            ssim_fused.WARPS = real
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the rows here")
    ap.add_argument("--only", choices=("k3", "k1"), help="probe one kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_k1_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}")
    rows = {"card": card}
    if args.only in (None, "k3"):
        rows["k3"] = k3(dev)
    if args.only in (None, "k1"):
        rows["k1"] = k1(dev)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
