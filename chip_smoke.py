#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mrisr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

1. Prints the card, builds the hand-written kernels from csrc/ (nvcc,
   sm_90a) and prints the build time.
2. Kernel phase: kernel A (int8 conv + fused epilogue) at all 19 conv sites
   of the full-width M2 UNet (features 64, 256^2) and kernel B (int8 2x2
   upconv + fused concat) at its 4 sites, with and without skip, at batch 2,
   each held against its plain PyTorch version on the card (int8: no code
   off by more than 1 and under 1 % off by 1; float: rtol 1e-5).  Then each
   site is timed at the serving batch (8) beside its plain version, a
   library call for the same product (a yardstick the port never calls)
   and its bound on an H100 SXM.
3. Slice phase: seeded UNet(features=64) -> BN fold -> calibrate on two
   noise batches -> int8 quantize -> bundle on disk -> engine_from_bundle
   (batch 8) answering 21 requests from two threads (so one batch is
   wrap-padded).  The answers must be finite (256, 256, 1), within rel-L2
   0.15 of the folded float forward (fp32) and 0.02 of the same tables run
   through the plain versions on the card, and both kernels must have been
   launched by that run.  Then the steady-state engine throughput.
4. K1 phase: the fused SSIM kernel against its plain version on the card
   (atol 3e-5, the JAX package's contract) at (1|8|64|174, 256, 256),
   (3, 37, 53), (2, 7, 7) and (1, 512, 512); an identical pair must give 1
   within 1e-6.  Then its time at N = 64 and 174 beside its bound and the
   plain version's.
5. Eval phase, full width: the port's CLI synthesizes a store of 12
   patients x 60 slices x 256^2 (test split: 3 patients, 174 3 mm and 168
   6 mm triplets); the seeded UNet is saved as a reference-layout
   unet_best.pt; the CLI runs eval (batch 8), predict-volume and
   predict-volume --hierarchical on it; then the runner evaluates the same
   store through the float model and through the int8 bundle's forward,
   keeping the predictions.  Both spacings must hold 174 and 168 samples,
   every SSIM must be finite in [-1, 1], K1's per-spacing SSIM must equal
   the plain SSIM of the same predictions within 3e-5, and K1 (and, for the
   bundle, kernels A and B) must have been launched.  Prints float vs int8
   SSIM/PSNR per spacing and the eval wall time per phase.  The weights are
   seeded, not trained: these numbers test the plumbing, not accuracy.

Prints the kernels' JSON line and the card's name and power limit before
the last line, which is {"ok": true, "device": {...}}.  With
``--sites-json PATH`` the per-site numbers also go to PATH.  Exits non-zero
on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8          # serving micro-batch of the slice phase and the timings
CHECK_BATCH = 2    # batch of the kernel-vs-plain checks
HW = 256
FEATURES = 64
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
SSIM_ATOL = 3e-5   # tests/test_ssim.py's kernel-vs-XLA contract
EVAL_PATIENTS, EVAL_SLICES = 12, 60
# test split of 12 patients = 3 patients x (60 - 2) d2 / (60 - 4) d4
EVAL_SAMPLES = {"3mm": 174, "6mm": 168}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, flush=None) -> float:
    """Median device time of one call of ``fn`` over ``reps`` back-to-back
    calls, each between two CUDA events, after warm-up.  ``flush`` runs
    before each call, outside the events (to evict the L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound_ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def code_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max code difference; raises past the +-1 / <1 % contract."""
    diff = (got.int() - want.int()).abs()
    worst = int(diff.max())
    off1 = float((diff == 1).float().mean())
    if worst > 1 or off1 >= 0.01:
        raise AssertionError(f"codes differ: max {worst}, {off1:.4%} off by 1")
    return float(worst)


def conv_sites():
    """(name, H, Ci, Co, k, out_float) of every kernel-A launch of one
    full-width int8_fused forward (skip_emit 'shared')."""
    f, sites, h = FEATURES, [], HW
    widths = [(2, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f),
              (8 * f, 16 * f)]
    for name, (ci, co) in zip(("enc1", "enc2", "enc3", "enc4", "bottleneck"),
                              widths):
        sites += [(f"{name}/Conv_0", h, ci, co, 3, False),
                  (f"{name}/Conv_1", h, co, co, 3, False)]
        h //= 2
    for lvl, co in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
        h = HW >> (lvl - 1)  # decN runs at upconvN's output size
        sites += [(f"dec{lvl}/Conv_0", h, 2 * co, co, 3, False),
                  (f"dec{lvl}/Conv_1", h, co, co, 3, False)]
    sites.append(("final", HW, f, 1, 1, True))
    return sites


def upconv_sites():
    """(name, H_in, C, Co) of the 4 kernel-B launches; skip has Co channels."""
    f = FEATURES
    return [(f"upconv{lvl}", HW >> lvl, 2 * co, co)
            for lvl, co in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f))]


def kernel_phase(dev):
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv2d_int8_plain, pack_conv)
    from mrisr_tpu_torch.ops.upconv import (
        pack_upconv, upconv2x2_int8, upconv2x2_int8_plain)

    g = torch.Generator(device=dev).manual_seed(1234)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo

    rows = []
    for name, h, ci, co, k, out_float in conv_sites():
        wp = pack_conv(codes((k, k, ci, co)))
        # spread y over tens to hundreds of codes, both sides of the clip
        s = uniform(co, 0.3, 2.3) * 60 / (127 * 127 / 3 * (k * k * ci) ** 0.5)
        b = uniform(co, -2, 2)
        relu = not out_float
        x = codes((CHECK_BATCH, h, h, ci))
        got = conv2d_int8(x, wp, s, b, relu=relu, out_float=out_float)
        torch.cuda.synchronize()
        want = conv2d_int8_plain(x, wp, s, b, relu=relu, out_float=out_float)
        if out_float:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max())
        else:
            err = code_diff(got, want)
        x = codes((BATCH, h, h, ci))
        ms = cuda_ms(lambda: conv2d_int8(x, wp, s, b, relu=relu,
                                         out_float=out_float), reps=20)
        plain_ms = cuda_ms(lambda: conv2d_int8_plain(
            x, wp, s, b, relu=relu, out_float=out_float), reps=3, warmup=1)
        # yardstick: cuDNN's bf16 conv of the same codes (products exact,
        # fp32 sums, no epilogue), channels_last
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wp.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            xb, wb, padding=k // 2), reps=20)
        m = BATCH * h * h
        ops = 2.0 * m * co * k * k * ci
        nbytes = m * ci + co * k * k * ci + 8 * co + m * co * (4 if out_float
                                                               else 1)
        rows.append({"kernel": "conv_int8", "site": name, "H": h, "Ci": ci,
                     "Co": co, "k": k, "batch": BATCH, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "ops": ops, "bytes": nbytes})

    for name, h, c, co in upconv_sites():
        w2, s4, b4 = pack_upconv(codes((2, 2, c, co)), uniform(co, 0.03, 0.23),
                                 uniform(co, -10, 10))
        errs = []
        for with_skip in (False, True):
            x = codes((CHECK_BATCH, h, h, c))
            skip = codes((CHECK_BATCH, 2 * h, 2 * h, co)) if with_skip else None
            got = upconv2x2_int8(x, w2, s4, b4, skip=skip)
            torch.cuda.synchronize()
            want = upconv2x2_int8_plain(x, w2, s4, b4, skip=skip)
            errs.append(code_diff(got[..., :co], want[..., :co]))
            if with_skip and not torch.equal(got[..., co:], skip):
                raise AssertionError(f"{name}: fused skip concat differs")
        x = codes((BATCH, h, h, c))
        skip = codes((BATCH, 2 * h, 2 * h, co))
        ms = cuda_ms(lambda: upconv2x2_int8(x, w2, s4, b4, skip=skip), reps=20)
        plain_ms = cuda_ms(lambda: upconv2x2_int8_plain(
            x, w2, s4, b4, skip=skip), reps=3, warmup=1)
        # yardstick: cuBLASLt's int8 matmul of the same product (int32 out,
        # no epilogue, no interleave, no concat)
        x2 = x.reshape(-1, c)
        try:
            lib_ms = cuda_ms(lambda: torch._int_mm(x2, w2), reps=20)
        except RuntimeError as e:
            print(f"{name}: torch._int_mm yardstick unavailable: {e}")
            lib_ms = None
        m = BATCH * h * h
        ops = 2.0 * m * c * 4 * co
        nbytes = m * c + 4 * co * c + 32 * co + 4 * m * co + 4 * m * 2 * co
        rows.append({"kernel": "upconv_int8", "site": name, "H": h, "C": c,
                     "Co": co, "Cs": co, "batch": BATCH,
                     "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "ops": ops, "bytes": nbytes})
    for r in rows:
        r["bound_ms"], r["ops_ms"], r["bytes_ms"] = bound_ms(r["ops"],
                                                             r["bytes"])
        print(f"{r['kernel']:12s} {r['site']:18s} err {r['max_abs_err']:.3g} "
              f"ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
              f"plain {r['plain_ms']:.3f} lib {r['library_ms']}")
    return rows


def seeded_unet(seed: int):
    """UNet(features=64) with He-normal conv weights and non-trivial BN
    statistics, all drawn from one torch.Generator."""
    from torch import nn

    from mrisr_tpu_torch.models import UNet

    g = torch.Generator().manual_seed(seed)
    model = UNet(features=FEATURES)

    def randn(t, std):
        return torch.randn(t.shape, generator=g) * std

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = (m.weight[0].numel() if isinstance(m, nn.Conv2d)
                          else m.weight.shape[0])
                m.weight.copy_(randn(m.weight, (2.0 / fan_in) ** 0.5))
                m.bias.copy_(randn(m.bias, 0.05))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(1 + randn(m.weight, 0.2))
                m.bias.copy_(randn(m.bias, 0.1))
                m.running_mean.copy_(randn(m.running_mean, 0.1))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
    return model.eval()


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def slice_phase(dev, card: str):
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, calibrate_unet, engine_from_bundle, quantize_unet,
        save_bundle)

    folded = fold_unet_batchnorm(seeded_unet(0).to(dev))
    n_params = sum(p.numel() for p in folded.parameters())
    rng = np.random.default_rng(1)
    calib_batches = [rng.standard_normal((BATCH, HW, HW, 2), np.float32)
                     for _ in range(2)]
    t0 = time.perf_counter()
    calib = calibrate_unet(folded, calib_batches)
    q = quantize_unet(folded, calib)
    print(f"fold+calibrate+quantize {time.perf_counter() - t0:.2f} s "
          f"(folded params {n_params})")
    requests = rng.standard_normal((21, HW, HW, 2), np.float32)

    with tempfile.TemporaryDirectory() as d:
        save_bundle(d, q, model_name="unet", quant="int8_fused",
                    base_features=FEATURES, image_size=(HW, HW),
                    calibration="2 noise batches, absmax")
        with engine_from_bundle(d, batch_size=BATCH) as eng:
            eng.predict(requests[0])  # warm-up: allocator, pinned buffers
            eng.reset_stats()
            # --- the main path: counts from 0, two client threads
            conv2d_int8.launches = 0
            upconv2x2_int8.launches = 0
            futures = [[], []]

            def client(k):
                futures[k] = [eng.submit(r) for r in requests[k::2]]

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results = [None] * len(requests)
            for k in range(2):
                for j, fut in enumerate(futures[k]):
                    results[k + 2 * j] = fut.result(timeout=600)
            launches = {"conv_int8": conv2d_int8.launches,
                        "upconv_int8": upconv2x2_int8.launches}
            main_stats = eng.stats
            # --- steady-state throughput
            eng.reset_stats()
            burst = [eng.submit(requests[i % len(requests)])
                     for i in range(16 * BATCH)]
            for fut in burst:
                fut.result(timeout=600)
            steady = eng.stats

    print(f"main path: {main_stats}; launches {launches}")
    served = np.stack(results)
    if served.shape != (len(requests), HW, HW, 1):
        raise AssertionError(f"served shape {served.shape}")
    if not np.isfinite(served).all():
        raise AssertionError("served outputs are not finite")
    if main_stats.padded_slots == 0:
        raise AssertionError("no batch was wrap-padded")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    x = torch.from_numpy(requests).to(dev)
    with torch.no_grad(), fp32_reference():
        y_fp = torch.cat([folded(x[i:i + BATCH])
                          for i in range(0, len(x), BATCH)]).cpu().numpy()
    plain = Int8FusedUNet(q, device=dev, plain=True)
    y_plain = torch.cat([plain(x[i:i + BATCH])
                         for i in range(0, len(x), BATCH)]).cpu().numpy()
    rel_fp, rel_plain = rel_l2(served, y_fp), rel_l2(served, y_plain)
    print(f"served vs float fp32 rel-L2 {rel_fp:.6f} (bound 0.15); "
          f"vs plain versions rel-L2 {rel_plain:.6f} (bound 0.02)")
    if not rel_fp < 0.15:
        raise AssertionError(f"served vs float rel-L2 {rel_fp}")
    if not rel_plain < 0.02:
        raise AssertionError(f"served vs plain rel-L2 {rel_plain}")
    print(f"engine steady-state slices/s {steady.slices_per_sec:.2f} "
          f"(batch {BATCH}, {steady.requests} requests, int8_fused, "
          f"features {FEATURES}, {HW}x{HW}; {card})")
    return launches, q, {"rel_l2_float": rel_fp, "rel_l2_plain": rel_plain,
                         "slices_per_sec": steady.slices_per_sec,
                         "fetch_time_s": steady.fetch_time_s,
                         "assemble_time_s": steady.assemble_time_s,
                         "total_batch_time_s": steady.total_batch_time_s,
                         "requests": steady.requests}


def ssim_bound(n: int, h: int, w: int, win: int = 7):
    """(bound ms, ops ms, bytes ms) of mean SSIM on n (h, w) pairs: x and y
    read once, one float written per image; 3 products per input pixel and
    86 fp32 operations per output pixel (5 x 2 (win - 1) window adds, 5
    scalings, the moments and the quotient)."""
    vh, vw = h - win + 1, w - win + 1
    ops = n * (3.0 * h * w + 86.0 * vh * vw)
    nbytes = 8.0 * n * h * w + 4.0 * n
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def ssim_phase(dev):
    """K1 against its plain version on the card, then its timings."""
    from mrisr_tpu_torch.ops.ssim_fused import ssim_fused, ssim_fused_plain

    g = torch.Generator(device=dev).manual_seed(7)

    def pair(shape):
        x = torch.rand(shape, generator=g, device=dev)
        noisy = x + 0.2 * torch.randn(shape, generator=g, device=dev)
        return x, noisy.clamp(0.0, 1.0)

    errs = []
    for shape in ((1, 256, 256), (8, 256, 256), (64, 256, 256),
                  (174, 256, 256), (3, 37, 53), (2, 7, 7), (1, 512, 512)):
        x, y = pair(shape)
        got = ssim_fused(x, y)
        torch.cuda.synchronize()
        want = ssim_fused_plain(x, y)
        err = float((got - want).abs().max())
        print(f"ssim {str(shape):16s} max |kernel - plain| {err:.3g}")
        if not err <= SSIM_ATOL:
            raise AssertionError(f"K1 at {shape}: max error {err}")
        if not torch.equal(ssim_fused(x, y), got):
            raise AssertionError(f"K1 at {shape}: two launches differ")
        errs.append(err)
    x, _ = pair((8, 256, 256))
    one_err = float((ssim_fused(x, x) - 1.0).abs().max())
    if not one_err <= 1e-6:
        raise AssertionError(f"K1 of an identical pair is off 1 by {one_err}")

    # 64 MiB write between launches: the eval hands K1 fresh predictions,
    # and N = 64 (34 MB) would otherwise sit in the 50 MB L2
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    rows = []
    for n in (64, 174):
        x, y = pair((n, 256, 256))
        ms = cuda_ms(lambda: ssim_fused(x, y), reps=20, flush=scrub.zero_)
        plain_ms = cuda_ms(lambda: ssim_fused_plain(x, y), reps=5,
                           flush=scrub.zero_)
        bound, t_ops, t_bytes = ssim_bound(n, 256, 256)
        rows.append({"kernel": "ssim", "site": f"N={n}", "N": n, "H": 256,
                     "W": 256, "max_abs_err": max(errs), "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound, "ops_ms": t_ops, "bytes_ms": t_bytes})
        print(f"ssim N={n:<4d} ms {ms:.4f} bound {bound:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
              f"plain {plain_ms:.3f}")
    return rows


def eval_phase(dev, qparams, card: str):
    """The port's eval path at full width, float and int8 (see the module
    docstring, item 5).  Returns (launches, results)."""
    import dataclasses

    from mrisr_tpu_torch import cli, fp32_reference
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
    from mrisr_tpu_torch.config import DataConfig, ModelConfig
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.eval.runner import evaluate_pair_model_test_set
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.ssim import ssim
    from mrisr_tpu_torch.ops.ssim_fused import ssim_fused
    from mrisr_tpu_torch.ops.stats import minmax_normalize
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve import make_bundle_apply

    def check_spacings(metrics, what):
        for label, want_n in EVAL_SAMPLES.items():
            m = metrics[label]
            if m["num_samples"] != want_n:
                raise AssertionError(f"{what} {label}: {m['num_samples']} "
                                     f"samples, want {want_n}")
            for k in ("ssim_mean", "ssim_min", "ssim_max"):
                if not (np.isfinite(m[k]) and -1.0 <= m[k] <= 1.0):
                    raise AssertionError(f"{what} {label} {k} = {m[k]}")

    def capture(fn, kept):
        def wrapped(x):
            y = fn(x)
            kept.append(y[..., 0])
            return y
        return wrapped

    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        models_dir = os.path.join(work, "models")
        results_dir = os.path.join(work, "results")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(EVAL_PATIENTS),
                  "--slices", str(EVAL_SLICES), "--size", str(HW)])
        os.makedirs(models_dir)
        torch.save(reference_checkpoint(seeded_unet(0), "unet", epoch=0,
                                        val_loss=1.0),
                   os.path.join(models_dir, "unet_best.pt"))
        print(f"eval set-up (synth + checkpoint) "
              f"{time.perf_counter() - t0:.2f} s")
        common = ["--model", "unet", "--data", store_dir, "--checkpoint-dir",
                  models_dir, "--features", str(FEATURES), "--image-size",
                  str(HW), "--device", str(dev)]

        # --- the main path: counts from 0, the user's entry points
        ssim_fused.launches = 0
        conv2d_int8.launches = 0
        upconv2x2_int8.launches = 0
        walls = {}
        with fp32_reference():
            t0 = time.perf_counter()
            cli.main(["eval", *common, "--results-dir", results_dir,
                      "--batch-size", str(BATCH)])
            walls["cli eval"] = time.perf_counter() - t0
            for flag in ([], ["--hierarchical"]):
                t0 = time.perf_counter()
                cli.main(["predict-volume", *common, *flag])
                walls[" ".join(["cli predict-volume", *flag])] = (
                    time.perf_counter() - t0)
        with open(os.path.join(results_dir, "unet_test_metrics.json")) as f:
            cli_metrics = json.load(f)
        check_spacings(cli_metrics, "cli eval")

        store = VolumeStore.open(store_dir)
        cfg = DataConfig(batch_size=BATCH, image_size=(HW, HW))
        model = load_model("unet", models_dir, checkpoint="required",
                           cfg=ModelConfig(base_features=FEATURES),
                           device=dev)
        runs = {}
        for what, fn in (("float", model.predict_nhwc),
                         ("int8", make_bundle_apply(
                             qparams, {"quant": "int8_fused"}, dev))):
            kept, timings = [], {}
            t0 = time.perf_counter()
            metrics = evaluate_pair_model_test_set(
                capture(fn, kept), store, cfg, device=dev, timings=timings)
            walls[f"runner {what}"] = time.perf_counter() - t0
            check_spacings(metrics, what)
            runs[what] = (metrics, kept, timings)
        launches = {"ssim": ssim_fused.launches,
                    "conv_int8": conv2d_int8.launches,
                    "upconv_int8": upconv2x2_int8.launches}
        # the targets, per spacing, in the runner's order (eval splits are
        # not shuffled)
        gts, bank = {}, None
        for dist, label in ((2, "3mm"), (4, "6mm")):
            loader = build_loader(
                store, "test", dataclasses.replace(cfg, distance_filter=dist),
                device=dev, bank=bank)
            bank = loader.bank
            gts[label] = torch.cat([b[..., 2] for b in loader])
    print(f"eval main path launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    # K1 against the plain SSIM of the same predictions, per spacing (the
    # runner ran the 3 mm batches, then the 6 mm ones)
    results = {"launches": launches, "wall_s": walls}
    for what, (metrics, kept, timings) in runs.items():
        preds = torch.cat(kept)
        n3 = EVAL_SAMPLES["3mm"]
        for label, pred in (("3mm", preds[:n3]), ("6mm", preds[n3:])):
            plain = float(ssim(minmax_normalize(gts[label]),
                               minmax_normalize(pred),
                               use_kernel=False).mean())
            diff = abs(plain - metrics[label]["ssim_mean"])
            print(f"{what} {label}: SSIM {metrics[label]['ssim_mean']:.6f} "
                  f"(plain {plain:.6f}, diff {diff:.2g}) PSNR "
                  f"{metrics[label]['psnr_mean']:.4f} dB")
            if not diff <= SSIM_ATOL:
                raise AssertionError(f"{what} {label}: K1 vs plain {diff}")
        print(f"{what} runner wall per phase (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
        results[what] = {"metrics": metrics, "timings_s": timings}
    print("eval wall (s): " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in walls.items())
          + f" ({card})")
    return launches, results


# kernel -> (CUDA source, what it replaces).  Kernel A replaces no
# pallas_call: XLA generated the int8 conv (_conv3x3 at :66) and its
# requantizing epilogue (_requant_epilogue at :204) on the TPU.
SOURCES = {
    "conv_int8": ("mrisr_tpu_torch/csrc/conv_int8.cu",
                  "mrisr_tpu/serve/quant.py:66"),
    "upconv_int8": ("mrisr_tpu_torch/csrc/upconv_int8.cu",
                    "mrisr_tpu/ops/upconv_pallas.py:130"),
    "ssim": ("mrisr_tpu_torch/csrc/ssim.cu",
             "mrisr_tpu/ops/ssim_pallas.py:91"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites-json", help="also write per-site numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mrisr_tpu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v[0]:.2f} s" for k, v in built.items()))
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = kernel_phase(dev)
    serve_launches, qparams, slice_result = slice_phase(dev, card)
    ssim_rows = ssim_phase(dev)
    eval_launches, eval_result = eval_phase(dev, qparams, card)

    kernels = []
    for name in ("conv_int8", "upconv_int8", "ssim"):
        # A and B: all sites of one batch-8 forward, summed; K1: one call
        # at N = 174, the eval's 3 mm test split
        sel = ([r for r in rows if r["kernel"] == name] if name != "ssim"
               else [r for r in ssim_rows if r["N"] == 174])
        ops_ms = sum(r["ops_ms"] for r in sel)
        bytes_ms = sum(r["bytes_ms"] for r in sel)
        libs = [r["library_ms"] for r in sel]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            # the serving path's and the eval path's runs, each counted
            # from 0 just before it
            "launches": serve_launches.get(name, 0) + eval_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None if None in libs else sum(libs),
        })
    if args.sites_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.sites_json)),
                    exist_ok=True)
        with open(args.sites_json, "w") as f:
            json.dump({"card": card, "sites": rows + ssim_rows,
                       "slice": slice_result, "eval": eval_result,
                       "kernels": kernels}, f, indent=1)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
