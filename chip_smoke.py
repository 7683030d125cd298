#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mrisr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

1. Prints the card, builds the hand-written kernels from csrc/ (nvcc,
   sm_90a) and prints the build time.
2. Kernel phase: kernel A (int8 conv + fused epilogue) at all 19 conv sites
   of the full-width M2 UNet (features 64, 256^2) and kernel B (int8 2x2
   upconv + fused concat) at its 4 sites, with and without skip, at batch 2,
   each held against its plain PyTorch version on the card (int8: the same
   codes, since both paths sum exactly; float: rtol 1e-5; two launches the
   same bits).  Each site names its path (conv_path / upconv_path: "tc",
   wgmma on the tensor cores, or "dp4a").  Then each site is timed at the
   serving batch (8), L2 warm and after a 64 MiB L2 scrub, beside its plain
   version, a library call for the same product (a yardstick the port
   never calls), its bound on an H100 SXM, the achieved TOP/s and the
   host's microseconds a launch.  Device times queue their launches behind
   a device-side sleep (cuda_ms), so they are the card's, not the host's
   enqueue rate.
3. Slice phase: seeded UNet(features=64) -> BN fold -> calibrate on two
   noise batches -> int8 quantize -> bundle on disk -> engine_from_bundle
   (batch 8) answering 21 requests from two threads (so one batch is
   wrap-padded).  The answers must be finite (256, 256, 1), within rel-L2
   0.15 of the folded float forward (fp32) and equal (rel-L2 0) to the same
   tables run through the plain versions on the card, and every site must
   have launched the path conv_path / upconv_path gives it, no other.  Then
   the steady-state engine throughput beside the __dp4a design's (quoted
   from PERF.md, not measured here), one forward's device time and enqueue
   time, and its profile.
4. K1 phase: the fused SSIM kernel (one pass of 128-column strips, a warp
   sliding down a band of rows with the vertical window in registers and
   the horizontal window through shuffles, so each input byte is read
   once) against its plain version on the card (atol 3e-5, the JAX
   package's contract) at SSIM_SHAPES: (1|8|64|174, 256, 256), (3, 37, 53),
   (2, 7, 7) and (1, 512, 512); two launches must give the same bits and an
   identical pair 1 within 1e-6.  Then its time at N = 64 and 174 beside
   its bound and the plain version's.
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
6. K3 phase: the fused GroupNorm+SiLU+int8 kernel (one cooperative launch
   walking the batch in passes of whole samples staged in the grid's shared
   memory, so x is read once) at the 10 sites of one full-width int8_deep
   Fast-DDPM forward (base 64, 256^2; C 128-768 at 128^2, 64^2 and 32^2),
   bf16 in, at batch 2 against its plain version (int8: no code more than 1
   off and under 0.1 % off by one; bf16 out: atol 0.03 below |y| = 8 and
   2^-8 |y| above, one bf16 rounding step; two launches give the same
   bits), then timed at batch 8 after a 64 MiB L2 scrub beside the plain
   version, F.group_norm (the yardstick: GroupNorm alone) and its bytes
   bound; each site prints its plan (one-read or two-read, samples a pass,
   passes).  K3's bf16 mode at the five float GroupNorm sites of the same
   forward (256^2, C 64-192, batch 8), where 'fused' routes them and
   'chain' runs gn_silu_chain, timed beside that chain on the same input,
   with the max |difference| of the two bf16 outputs.  K3 with a shift (a
   ResBlock's time projection, added to x in float32 as it is read) at the
   forward's 7 norm2 sites, int8 codes where the site is int8 (bf16 at the
   two 256^2 ones): at batch 2 the plain version's codes exactly (bf16
   within the tolerance above), then timed at the serving batch of the
   Fast-DDPM cells (32) beside the same site without a shift.  Kernel A at
   the 14 diffusion sites (float epilogue, no ReLU) and kernel B's float mode at
   upconv3 and upconv2, against their plain versions (rtol 1e-5, two
   launches the same bits), and timed as in 2.
7. Diffusion phase: a seeded full-width FastDDPMUNet (13,899,905
   parameters) saved as a reference-layout fastddpm_best.pt; a 12 x 60 x
   256^2 store from the CLI's synth; the CLI's export-serving makes an
   int8_deep bundle (calibrated on 2 val batches of 8) and a bf16 one;
   engine_from_bundle (batch 8, gn_impl 'fused') answers 10 test-split
   [pre, post] requests from two threads with the 10-step ancestral
   sampler.  The samples must be finite (256, 256, 1), within rel-RMSE 0.35
   of the bf16 float sampler and equal (rel-L2 0) to the same tables
   through the plain versions, on the batches the engine formed (same
   noise: every call seeds its generator with 0), K3, A, B and the
   quantizer must have been launched 150, 140, 20 and 60 times a batch,
   70 of the K3 launches with
   a shift (a ResBlock's norm2), A and B all on the tensor cores.  Then the steady-state slices/s beside the __dp4a design's
   (quoted from PERF.md, not measured here), the engine's fetch/assemble
   split, one sampler call's time on the card and a profiled call for
   int8_deep 'fused', int8_deep 'chain' and the bf16 bundle.
8. Training phase, full width: the unet_combined preset (features 64,
   31,042,945 parameters, 256^2, batch 4, Adam 1e-4, MSE + 0.1 (1 - SSIM) +
   0.1 Gabor/LoG) on a CLI-synthesized store of 8 patients x 24 slices (53
   steps an epoch).  One float32 train step (augmentation off) on the card
   and on the CPU from the same init_model weights, each held against the
   same step in float64 on the CPU: the card's loss within rel 1e-4, its
   BN running statistics within 1e-4, each gradient within rel-L2 1e-3 or
   within 10x the CPU float32 step's own error on that tensor (a conv bias
   right before a training-mode BatchNorm, zero in exact arithmetic, is
   measured against its weight's gradient); the card runs under
   fp32_reference.  One step's device time, the device busy share
   over 5 steps and a torch.profiler split of one step (forward and
   backward convs, BatchNorm, the MSE, SSIM and Gabor terms forward and
   backward, the optimizer), and one epoch with the batches gathered on the
   card.  Then the CLI: train --epochs 2, train --epochs 3 --resume (finite
   losses, epoch 2 below epoch 1, the resumed run starting at 3, the five
   checkpoint files, the history JSON's series); eval --model
   unet_combined on the trained checkpoint (K1 launched, each spacing's
   SSIM within 3e-5 of the plain SSIM of the same predictions);
   export-serving --quant int8_fused and engine_from_bundle serving 12
   test-split requests (within rel-L2 0.15 of the folded float forward,
   equal to the plain versions, every A/B site on its path).  Prints the
   training steps/s and slices/s over the second epoch.  The conv route of
   models/conv.py: dec2.conv.0 (256 -> 128 at 128^2, batch 4) forward and
   backward routed around cuDNN's FFT convolution (at most 20 ms, within
   1e-5 of cuDNN's output), and the train step with no route (cuDNN at
   every conv) beside the routed one.
9. Families phase, full width: the unet_gan, deepcnn, progressive_unet,
   fastddpm and fastddpm_simple presets (features 64, 256^2, batch 4) on a
   CLI-synthesized store of 8 patients x 12 slices (23 steps an epoch, 10
   for the progressive windows); every registry model's parameter count.
   One float32 train step on the card and on the CPU against the same step
   in float64 (phase 8's bounds; for the GAN, G and D, and the Fast-DDPM,
   also the card's worst gradient at most 2x the CPU's) at full size for
   the GAN and the Fast-DDPM, at 64^2 and batch 2 for the other three.
   Then, each through the CLI: fastddpm train 1 epoch, --resume to 2,
   export-serving --quant int8_deep, served at batch 8 (K3, A, B; against
   the float32 sampler on the same noise, rel-RMSE < 0.35, and the plain
   versions, equal); unet_gan the same with eval (K1 against the plain
   SSIM) and int8_fused serving (A, B); deepcnn, progressive_unet
   (per-stage metrics) and fastddpm_simple (DDIM) train 1 epoch and eval
   through K1.  Prints each family's losses, steps/s and wall.
10. bf16 phase, full width: the six families in bf16 compute (float32
   parameters, loss and optimizer; ``train --bf16``) on an 8 x 12 x 256^2
   store.  One bf16 train step of each family on the card and on the CPU
   at 64^2 and batch 2 from the same weights and batch, each held against
   the same step in float64: losses within rel 2e-2, the weights' and norm
   parameters' gradients as one vector within rel-L2 0.5, the card's worst
   tensor at most 2x the CPU's.  Each family's full-size bf16 step (256^2,
   batch 4): its device time, its conv and matmul FLOPs
   (``torch.utils.flop_counter``) and their bound at 989 TFLOP/s, and its
   torch.profiler split.  Then the CLI: unet_combined train --bf16 1 epoch
   and --resume to 2, fastddpm 1 epoch (steps/s); eval of the bf16-trained
   unet_combined (``--bf16`` taken, K1 equal to the plain SSIM);
   export-serving --quant none and --quant int8 served by
   engine_from_bundle (none within rel-L2 0.05 of the folded float32
   forward; int8 within 0.15 and equal to the plain versions, kernel A 18
   launches a forward on its paths); engine_from_model quant none (float32
   over bf16-rounded weights, within 1e-2), int8 and int8_fused (within
   0.15; A, and B for int8_fused, on their paths); the same calibration
   without its upconv/final entries served by the int8_fused fallback
   (within 0.15, equal to the plain versions, A 22 launches a forward).
11. Distillation phase, full width, from phase 8's trained unet_combined
   (the teacher) and phase 9's trained fastddpm, on a phase 8-sized store.
   One float32 distill step (float teacher, pruned init, EMA 0.999, SSIM
   term) on the card and on the CPU at 64^2, batch 2, against float64
   (phase 8's bounds; the EMA within 1e-5).  The int8_fused teacher at
   batch 32 equal to its plain versions (A 19, B 4 launches).  cli distill
   (the unet_distilled preset: features 32, batch 32, bf16, augment;
   --teacher-quant int8_fused --init-from-teacher --ema 0.999
   --distill-lambda-ssim 0.1) 1 epoch, a trainer resumed from epoch 1
   holding the checkpoint's live and averaged weights, then --resume to 2:
   the teacher's A and B launches, 19 and 4 per train and val step, on
   their paths; one step's device and host ms and steps/s.  eval --model
   unet_distilled (K1 within 3e-5 of plain); export-serving of the student
   and of the teacher (int8_fused), the student served at batch 8 (0.0
   from plain, rel-L2 < 0.15 from its folded float forward) and both
   engines' steady-state slices/s in turns.  cli distill-steps --teacher
   fastddpm --rounds 2 --factor 2 (10 -> 5 -> 3, 1 epoch a round, eval
   through K1), a step-distill step's device ms, export-serving --quant
   int8_deep of fastddpm, fastddpm_steps5 and fastddpm_steps3 (meta
   'ancestral', 'ddim_grid', 'ddim_grid'), the two students served (0.0
   from plain, rel-RMSE < 0.35 from the float ddim_grid sampler on the
   same conds and x_T; K3 15, A 14, B 2 launches a step) and one sampler
   call of each of the three at batch 8.  The student's and the _steps5
   bundle's HTTP front end (127.0.0.1, port 0): answers equal to the
   engine's forward, /healthz, /stats counting the requests, 400 on a bad
   body.
12. Ingest phase, at the size of the real data's series, from phase 8's
   trained unet_combined and phase 9's trained deepcnn and
   progressive_unet.  The port's write_dicom writes a tree shaped like the
   Prostate-MRI-US-Biopsy download: 12 patients, each one T2 series of 60
   slices of 256^2 uint16 from the seeded phantom generator (Z 1.5 mm
   apart, pixels 0.664 mm), plus two US-modality, two 'T2 3D RENDERING'
   and two 59-slice decoy series; zipped.  Then the CLI: extract, clean
   --dry-run (nothing deleted), clean --yes (exactly the four US and
   rendering series removed), pack (the 59-slice series left out; every
   volume bit-equal to its uint16 source as float32; Z spacing 1.5).  The
   native header scanner must have built, and its headers equal the Python
   parser's for every file; the header scan's files/s both ways (host
   numbers).  predict-volume --export-dicom of unet_combined, plain and
   --hierarchical, and of progressive_unet (the window path): K1's SSIM per
   slice within 3e-5 of the plain SSIM of the same predictions, the
   exported series read back equal to the uint16 map of the predicted
   volume, Z 1.5 mm.  compare of the three models live (2 batches a
   spacing), eval of each, compare --from-results: the rows within 1e-5,
   the CSV equal.  predict-volume --figure and triplet-figure render where
   matplotlib imports, and otherwise must refuse with an ImportError
   naming it.  K1 must have been launched; the phase's wall by step.
13. Parallel phase, data parallelism (``parallel/mesh.py``), from phase
   8's trained unet_combined and phase 9's trained fastddpm, on an 8 x 8 x
   256^2 store.  (a) One float32 unet_combined step at full width (31,042,945
   parameters), global batch 4, augmentation off, by two ranks sharing the
   card over gloo (this script with --dp-rank, 2 rows each, cross-rank
   BatchNorm, one gradient all-reduce) against the single-process step on
   the card: loss rel 1e-4, BN running statistics 1e-4, each gradient
   rel-L2 1e-3 or 10x the single step's own float32 error against float64
   on the CPU (phase 8's bounds), both ranks reporting the same loss.
   (b) The same for one float32 distill step (half-width student, the
   int8_fused teacher on each rank's rows: A 19 and B 4 launches a rank,
   on their paths).  (c) python -m torch.distributed.run --standalone
   --nproc-per-node 1 -m mrisr_tpu_torch train --mesh-data 1 --epochs 1
   writes one checkpoint set; --mesh-data 2 exits non-zero with the JAX
   CLI's "requests 2x1 devices but only 1 is visible".  (d) The int8_fused
   pair bundle served with data_parallel=True (every visible card) and with
   two replicas on the card: bit-identical with the plain engine, A and B
   on their paths; the int8_deep Fast-DDPM bundle over two replicas
   (global noise draws) within rel-RMSE 0.35 of the bf16 sampler and
   bit-identical with the single engine.  Its denoiser at 8 rows and at
   its first 4 (row_witness): every conv input (the forward's stats hook),
   the time embedding and every dispatcher op give rows 0-3 the same bits;
   the bf16 bundle's denoiser is traced the same way and its first
   differing site and op printed.  The phase's wall by step (two ranks on
   one card: not a scaling number).
14. Model-axis phase, the 'model' mesh axis (``parallel/mesh.py``), four
   ranks sharing the card over gloo (this script with --tp-rank).  (a)
   shard_module at a model axis of 2 (ranks 0 and 1, a 1 x 2 mesh, the
   default min_size: 18 of the UNet's tensors, 19 of the Fast-DDPM's) of
   the seeded full-width M2 UNet (batch 8, 256^2) and of the seeded
   Fast-DDPM UNet at timestep 500, float32 with TF32 off, against the
   single-process forward on the card: rel-L2 within 1e-4, the max |diff|,
   and the parameters and bytes each rank holds.  Each sharded conv (half
   its output channels) timed once on its own at the forward's input
   beside its float32 bound (67 TFLOP/s, 3.35 TB/s); any over 10x is
   flagged.  (b) One float32 unet_combined step at full width (global
   batch 4, augmentation off, TF32 off) on a 2 x 2 mesh of the four ranks
   (deterministic algorithms), after one warm-up step on that mesh: the
   two model coordinates' gradients and BatchNorm statistics bit-equal,
   and bit-equal to the same step on phase 13's 2-rank mesh, run by ranks
   0 and 1 in the same processes, and on the 2-rank mesh of ranks 2 and
   3 (phase 13's bounds are checked too).  The witness compares each data
   rank's own gradients before the all-reduce, the warm-up step's too (a
   process's first call at dec2.conv.0's shape gets other bits from
   cuDNN, so the first step is reported, not compared).  The steps run
   before the forwards of (a), so all four ranks have the same history.
   No kernel is on this path; its launch counts are printed.
15. Names phase: the JAX package's last public names in the port.  At the
   full-width UNet's four upconv sites at batch 8 (1024 -> 512 at 16^2 ...
   128 -> 64 at 128^2), UpConv2x2(impl='pixel_shuffle') (one matmul and
   the phase interleave) against the ConvTranspose2d of the same state
   dict, float32 with TF32 off (max |diff| within 1e-5) and in bf16
   compute (within two bf16 ulps of the largest output), each one's
   forward and forward+backward ms.  resize_bilinear (antialias off and
   on) and resize_bilinear_nhwc on one 60 x 512^2 volume to 256^2, card
   against CPU within 1e-5; max_pool_3x3_s1 card against CPU, exact;
   param_count of every family at its preset's width (module and state
   dict) against the known counts; convert_torch_vgg16 of a
   torchvision-keyed state dict on the card, and the VGG perceptual loss
   from its npz on the card against the CPU (rel 1e-5).  No kernel is on
   this path; its launch counts are printed.
16. Remat phase, activation rematerialization (``ModelConfig.remat``,
   ``models/blocks.py:remat``) of the full-width unet_combined (features
   64, 256^2, batch 4, float32, TF32 off).  (a) From one init and phase
   8's batch, a plain step and a remat step on the card (cuDNN's
   deterministic algorithms, after a warm-up step): losses equal, every
   remat gradient within phase 8's bounds of phase 8's float64 CPU step,
   running statistics equal to the plain step's, num_batches_tracked 1.  (b) The same pair in bf16 compute at
   64^2, batch 2: the remat step card and CPU vs float64 under phase 10's
   bounds, and remat vs plain on the card within them.  (c) One step's
   peak of torch.cuda.max_memory_allocated, with the port's convs and
   with cuDNN off, and its device ms, plain and remat, at batch 4 and 32,
   and the largest batch of REMAT_PROBES at which one step completes
   (only torch.cuda.OutOfMemoryError counts as not fitting): what remat's
   step adds at its peak at batch 32 with cuDNN off at least
   REMAT_PEAK_FACTOR below what plain's adds (with cuDNN's heuristic both
   peaks hold one conv's workspace, 22 GB), remat's largest batch at
   least plain's.  (d) Phase 13's rank pair takes the plain and the remat
   step on that batch (deterministic algorithms, after a warm-up step, as
   in phase 14): the remat step against the plain one under phase 13's
   bounds, its running statistics bit-equal, both ranks reporting the
   same loss.  No kernel is on this path; its launch counts are printed.
17. DDPM phase: the DDPM UNet that Fast-DDPM publishes
   (``models/ddpm_unet.py``) at the fastddpm_pmub preset's widths (ch 128,
   32 GroupNorm groups of 4 to 32 channels, eps 1e-6), seeded, calibrated
   on one batch of 2 over the 10-step sampler and quantized int8_deep.
   One denoiser call at batch 32, 256^2, with the launch counts set to 0
   just before it: 71 K3 (32 of them with a shift: the ResBlocks' norm2),
   99 A, no B, 27 quantizer and 12 kernel E launches (5 of E's with a
   residual: the 256^2 ResBlocks' closing adds), K3 seen at 71 sites, the
   quantizer at 27 and E at 12, the answer finite and the same bits on a
   second call, then the call timed.
   K3 at batch 32 at each distinct (size, channels, group, SiLU or not,
   int8 or bf16) of those 71 sites, the 256^2 x 256 sites and the six
   attention norms without SiLU among them, against its plain version:
   at int8 sites no code more than 1 off and under 0.1 % off by one, the
   same bits twice; the bf16 output at every site within one bf16
   rounding step (phase 6's tolerance); each shape's plan and time.  At
   the shapes of the shifted sites, K3 with a shift too: int8 codes equal
   to the plain version's, bf16 within that tolerance, and its time beside
   the same shape's without a shift.  The quantizer at batch 32 at each
   distinct (size, channels) of its inputs in that call and in the
   notebook net's int8_deep call, from bf16 and float32: the plain
   version's codes bit for bit (saturating both ends), the same codes
   twice, its time against its byte bound and the plain version's time.
   Kernel E (a float conv's bias, with a ResBlock's residual and its
   shortcut conv's bias) at batch 32 at each distinct (size, channels,
   mode) of its calls in that call: the plain version's bits, in place, r
   untouched, the same bits twice, its time against its byte bound (2 B
   read and written an element of y, 2 B read of r; the L2 flushed before
   each launch) and the plain version's time.
   Then ADM's UNet (``models/adm_unet.py``) at the fastddpm_adm preset's
   widths (ch 256, 32 groups of 8 to 64 channels, eps 1e-5), seeded,
   calibrated and quantized as the DDPM UNet is: one denoiser call at
   batch 2 with the counts set to 0 just before it: 101 K3 (42 of them in
   the scale-shift mode: the ResBlocks' out_layers norms; none with a
   shift), 121 A, no B, 38 quantizer and 13 kernel E launches (6 with a
   residual), the 16 attention cores
   on torch's fused path, both channels out and finite, the same bits on a
   second call, and within 2 % (rel L2) of the same tables through the
   kernels' plain versions.  K3 at batch 32 at each of that call's
   distinct shapes that the DDPM UNet lacks (the scale-shift norms, with
   their (32, 2 C) rows, and the groups of 48 and 64 channels at 1536 and
   2048): int8 codes equal to the plain version's, bf16 within one
   rounding step, the same bits twice, one launch counted (in
   ``launches_scale_shift`` too where it scale-shifts), and its time
   against its bound (the rows' 8 n C bytes counted).  The quantizer
   check above covers ADM's (size, channels) too.
   Then DiT-XL/8 (``models/dit.py``, 256^2: 1024 tokens of 1152
   channels), seeded with torch's default init, calibrated and quantized
   int8_deep: one denoiser call at batch 2 with the counts set to 0 just
   before it: 112 A (28 in the GELU form, all 112 in the GEMM form), 57
   kernel L (56 emitting codes), 28 quantizer and 56 gated kernel E
   launches, the 28 attention cores on torch's fused path and none on the
   float one, the same bits twice, within 2 % (rel L2) of the plain
   versions'.  At batch 32 at DiT's shapes, one launch counted each: L
   emitting codes and bf16 (the plain version's bits, bf16 within one
   rounding of the float64 formula), A's GELU form at fc1 (1152 -> 4608;
   within one code of the plain version's, fewer than 1e-4 apart) and E's
   gated form (the plain version's bits, in place), each the same bits
   twice, timed against its bound and the plain version.
   Last, kernel A at every 1x1 site of the DiT, ADM and DDPM calls above
   and of one int8_deep call of the notebook net (its 4 skips), each
   recorded during its call, at batch 32, on both tensor-core forms (the
   GELU sites on the GEMM form alone): the GEMM form's bits equal to the
   conv form's and to the plain version's (GELU within one code), each
   form's time with
   the L2 flushed, the bound and the plain version's time, the form
   ``conv_form`` picks, and the sites where it is the slower: the table
   behind the routing rule.

Prints the whole script's wall time, the kernels' JSON line (A and B with
their launches by path; A's GELU and E's gated form at DiT's shape, and
A's GEMM form over DiT's 1x1 sites, under ``forms``; L over the 57 sites
of a batch-32 DiT call) and the card's name and power limit before the
last line, which is {"ok": true, "device": {...}}.  With
``--sites-json PATH`` the per-site numbers also go to PATH.  Exits non-zero
on any failure.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

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
# K1's check shapes: the eval's (test split: 174 3 mm triplets), ragged
# tiles, a 1x1 map, a 512^2 image
SSIM_SHAPES = ((1, 256, 256), (8, 256, 256), (64, 256, 256), (174, 256, 256),
               (3, 37, 53), (2, 7, 7), (1, 512, 512))
# steady-state slices/s of the __dp4a design of kernels A and B, quoted from
# PERF.md (NVIDIA H100 80GB HBM3, 700 W) and printed labelled as quoted:
# this run measures none of them
DP4A_QUOTED_SLICES = {"unet": 710.05, "int8_deep fused": 31.57,
                      "int8_deep chain": 24.79, "none (bf16)": 45.20}
EVAL_PATIENTS, EVAL_SLICES = 12, 60
# test split of 12 patients = 3 patients x (60 - 2) d2 / (60 - 4) d4
EVAL_SAMPLES = {"3mm": 174, "6mm": 168}
# Fast-DDPM at the fastddpm preset (base 64, time_dim 128, 10 steps)
FASTDDPM_PARAMS = 13_899_905
UNET_PARAMS = 31_042_945  # the M2 UNet at features 64
DIFF_REQUESTS = 10  # served from two threads at batch 8: one batch padded
# training phase: the unet_combined preset's batch; a store whose train
# split (5 of 8 patients x 42 triplets) gives 53 steps an epoch
TRAIN_PATIENTS, TRAIN_SLICES = 8, 24
TRAIN_BATCH = 4
TRAIN_REQUESTS = 12  # served at batch 8: one batch padded
# phase 9: a store whose train split (5 of 8 patients x 18 triplets) gives
# 23 steps an epoch at batch 4 (10 of 5-slice windows); the card-vs-CPU
# step of DeepCNN, the Progressive UNet and the simple Fast-DDPM at
# SMALL_HW and SMALL_BATCH
FAMILY_PATIENTS, FAMILY_SLICES = 8, 12
SMALL_HW, SMALL_BATCH = 64, 2
# a float32 gradient vs the float64 step: within GRAD_RTOL, or within
# GRAD_NOISE_FACTOR times the CPU's own float32 error on the same tensor.
# Behind a stack of training-mode BatchNorms at random init, float32
# rounding alone moves deep gradients by 0.3-1 % (two CPU thread counts
# differ by that much: features 16, 128^2), far past 1e-3; TF32 would move
# them thousands of times more.
GRAD_RTOL, GRAD_NOISE_FACTOR = 1e-3, 10.0
STEADY_BATCHES = 6  # per serving setup
GN_BF16_ATOL = 0.03  # K3's bf16 output vs its plain version, |y| < 8
# phase 17: the DDPM UNet at the fastddpm_pmub preset (ch 128) and its
# serving batch; one int8_deep call launches K3 at all 71 GroupNorms and
# kernel A at the 99 stride-1 convs below the 256^2 level
DDPM_CH, DDPM_BATCH = 128, 32
DDPM_K3, DDPM_A, DDPM_QUANT = 71, 99, 27
# kernel E's launches a denoiser call, and those with a residual: the
# notebook net's, the DDPM UNet's, ADM's
NOTEBOOK_E, DDPM_E, ADM_E = (4, 2), (12, 5), (13, 6)
DDPM_SHIFTED, NOTEBOOK_SHIFTED = 32, 7  # K3 launches with a shift a call
# ADM's UNet (the fastddpm_adm preset): one int8_deep call's launches of
# K3 (all 101 GroupNorms; the 42 out_layers norms scale-shift), A, the
# quantizer and the fused attention core; its answer against the plain
# versions' (rel L2)
ADM_CH = 256
ADM_K3, ADM_SCALE_SHIFT, ADM_A, ADM_QUANT, ADM_ATTN = 101, 42, 121, 38, 16
ADM_PLAIN_REL = 0.02
# DiT-XL/8 (the fastddpm_dit preset): one int8_deep call's launches of A
# (the 112 block linears, the 28 fc1 in the GELU form), L (57: 56 emitting
# codes, the final layer's bf16), the quantizer (28: each proj's input),
# E's gated form (56) and the fused attention core (28); its answer
# against the plain versions' (rel L2)
DIT_A, DIT_GELU, DIT_L, DIT_L_CODES = 112, 28, 57, 56
DIT_QUANT, DIT_GATE, DIT_ATTN = 28, 56, 28
DIT_PLAIN_REL = 0.02
SLEEP_CYCLES = 20_000_000  # cuda_ms's head start for the host, ~10 ms
# fp32 operations per element of K3: 3 for the sums, 2 for the affine,
# 5 for SiLU (exp counted as one), 3 for the quantizer
GN_OPS_PER_ELEM = 13


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, flush=None) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls, each
    between two CUDA events, after warm-up.  The calls are queued behind a
    device-side sleep (about 10 ms), so the events bracket the card's work
    and not the host's enqueue rate: a kernel of tens of microseconds
    launched through a Python wrapper would otherwise wait for the host.
    ``flush`` runs before each call, outside the events (to evict the L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn``, enqueue only (no synchronize inside
    the loop): the wrapper's cost that a forward pays per launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound_ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def check_exact(got: torch.Tensor, want: torch.Tensor, again: torch.Tensor,
                what: str) -> float:
    """Kernels A and B sum exactly and round as their plain versions do:
    int8 codes must be equal, float32 within rtol 1e-5 (max |diff| is
    returned), and a second launch must give the same bits."""
    if not torch.equal(again, got):
        raise AssertionError(f"{what}: two launches differ")
    if got.dtype == torch.int8:
        if not torch.equal(got, want):
            diff = (got.int() - want.int()).abs()
            raise AssertionError(f"{what}: codes differ: max {int(diff.max())}"
                                 f", {int((diff > 0).sum())} off")
        return 0.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return float((got - want).abs().max())


def site_timing(row, fn, scrub):
    """The site's device ms with the L2 warm (20 launches on the same
    inputs) and after a 64 MiB L2 scrub, the host's
    microseconds a launch, the achieved TOP/s and the share of its bound."""
    row["ms"] = cuda_ms(fn, reps=20)
    row["ms_cold"] = cuda_ms(fn, reps=20, flush=scrub.zero_)
    row["host_us"] = host_us(fn)
    row["bound_ms"], row["ops_ms"], row["bytes_ms"] = bound_ms(row["ops"],
                                                               row["bytes"])
    row["tops"] = row["ops"] / row["ms"] / 1e9
    row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]


def print_site(r):
    print(f"{r['kernel']:12s} {r['site']:26s} {r['path']:4s} err "
          f"{r['max_abs_err']:.3g} ms {r['ms']:.4f} cold {r['ms_cold']:.4f} "
          f"bound {r['bound_ms']:.4f} ({r['pct_of_bound']:.1f} %, "
          f"{r['tops']:.1f} TOP/s) plain {r['plain_ms']:.3f} lib "
          f"{r['library_ms']} host {r['host_us']:.1f} us")


def conv_sites(f: int = FEATURES):
    """(name, H, Ci, Co, k, out_float) of every kernel-A launch of one
    int8_fused forward of the UNet at width ``f`` (skip_emit 'shared')."""
    sites, h = [], HW
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


def upconv_sites(f: int = FEATURES):
    """(name, H_in, C, Co) of the 4 kernel-B launches of the UNet at width
    ``f``; skip has Co channels."""
    return [(f"upconv{lvl}", HW >> lvl, 2 * co, co)
            for lvl, co in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f))]


def kernel_phase(dev):
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv2d_int8_plain, conv_path, pack_conv)
    from mrisr_tpu_torch.ops.upconv import (
        pack_upconv, upconv2x2_int8, upconv2x2_int8_plain, upconv_path)

    g = torch.Generator(device=dev).manual_seed(1234)
    scrub = torch.empty(16 * 2 ** 20, device=dev)

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

        def run(x):
            return conv2d_int8(x, wp, s, b, relu=relu, out_float=out_float)

        x = codes((CHECK_BATCH, h, h, ci))
        got = run(x)
        torch.cuda.synchronize()
        want = conv2d_int8_plain(x, wp, s, b, relu=relu, out_float=out_float)
        err = check_exact(got, want, run(x), name)
        x = codes((BATCH, h, h, ci))
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
        row = {"kernel": "conv_int8", "site": name, "H": h, "Ci": ci,
               "Co": co, "k": k, "batch": BATCH,
               "path": conv_path(ci, co, k), "max_abs_err": err,
               "plain_ms": plain_ms, "library_ms": lib_ms, "ops": ops,
               "bytes": nbytes}
        site_timing(row, lambda: run(x), scrub)
        rows.append(row)

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
            errs.append(check_exact(got, want, upconv2x2_int8(
                x, w2, s4, b4, skip=skip), f"{name} skip={with_skip}"))
        x = codes((BATCH, h, h, c))
        skip = codes((BATCH, 2 * h, 2 * h, co))
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
        row = {"kernel": "upconv_int8", "site": name, "H": h, "C": c,
               "Co": co, "Cs": co, "batch": BATCH,
               "path": upconv_path(c, co), "max_abs_err": max(errs),
               "plain_ms": plain_ms, "library_ms": lib_ms, "ops": ops,
               "bytes": nbytes}
        site_timing(row, lambda: upconv2x2_int8(x, w2, s4, b4, skip=skip),
                    scrub)
        rows.append(row)
    for r in rows:
        print_site(r)
    for kernel in ("conv_int8", "upconv_int8"):
        sel = [r for r in rows if r["kernel"] == kernel]
        print(f"{kernel}: {len(sel)} sites of one UNet forward (batch "
              f"{BATCH}): ms {sum(r['ms'] for r in sel):.4f}, cold "
              f"{sum(r['ms_cold'] for r in sel):.4f}"
              f", bound {sum(r['bound_ms'] for r in sel):.4f}, library "
              f"{sum(r['library_ms'] or 0 for r in sel):.4f}")
    return rows


def path_counts(sites, path_of):
    """{path: launches of one forward} over ``sites``."""
    counts = {"tc": 0, "dp4a": 0}
    for site in sites:
        counts[path_of(site)] += 1
    return counts


def reset_counts(conv, up):
    """Set the launch counts of kernels A (``conv``) and B (``up``), every
    path's and form's, K3's (all, with a shift, with a scale-shift), the
    quantizer's, kernel E's (all, with a residual, gated) and kernel L's
    (all, emitting codes) to 0."""
    from mrisr_tpu_torch.ops.bias_residual import bias_residual
    from mrisr_tpu_torch.ops.conv_int8 import reset_launches
    from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu
    from mrisr_tpu_torch.ops.layernorm import layernorm_modulate
    from mrisr_tpu_torch.ops.quantize import quantize_int8

    reset_launches(conv, up)
    groupnorm_silu.launches = groupnorm_silu.launches_shift = 0
    groupnorm_silu.launches_scale_shift = 0
    quantize_int8.launches = 0
    bias_residual.launches = bias_residual.launches_residual = 0
    bias_residual.launches_gate = 0
    layernorm_modulate.launches = layernorm_modulate.launches_codes = 0


def launch_counts(conv, up):
    """Launches of kernels A (``conv``) and B (``up``) since
    ``reset_counts``: all, and by path (``"conv_int8/tc"``, ...), A's GELU
    and GEMM forms; the quantizer's; kernel E's, all, with a residual and
    gated; kernel L's, all and emitting codes."""
    from mrisr_tpu_torch.ops.bias_residual import bias_residual
    from mrisr_tpu_torch.ops.layernorm import layernorm_modulate
    from mrisr_tpu_torch.ops.quantize import quantize_int8

    out = {"quantize_int8": quantize_int8.launches,
           "bias_residual": bias_residual.launches,
           "bias_residual/residual": bias_residual.launches_residual,
           "bias_residual/gate": bias_residual.launches_gate,
           "layernorm_modulate": layernorm_modulate.launches,
           "layernorm_modulate/codes": layernorm_modulate.launches_codes,
           "conv_int8/gelu": conv.launches_gelu,
           "conv_int8/gemm": conv.launches_gemm}
    for name, fn in (("conv_int8", conv), ("upconv_int8", up)):
        out[name] = fn.launches
        for p in ("tc", "dp4a"):
            out[f"{name}/{p}"] = getattr(fn, f"launches_{p}")
    return out


def check_paths(launches, per_forward, forwards, what):
    """Every site that conv_path / upconv_path gives a path launched it,
    and no other path moved: ``per_forward`` is {kernel: {path: n}}."""
    for kernel, want in per_forward.items():
        got = {p: launches[f"{kernel}/{p}"] for p in want}
        if got != {p: n * forwards for p, n in want.items()}:
            raise AssertionError(
                f"{what} {kernel}: launches by path {got} for {forwards} "
                f"forwards, want {want} a forward")


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
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv_path)
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8, upconv_path
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
            reset_counts(conv2d_int8, upconv2x2_int8)
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
            launches = launch_counts(conv2d_int8, upconv2x2_int8)
            main_stats = eng.stats
            # --- steady-state throughput
            eng.reset_stats()
            burst = [eng.submit(requests[i % len(requests)])
                     for i in range(16 * BATCH)]
            for fut in burst:
                fut.result(timeout=600)
            steady = eng.stats
            # one forward's device time and profile, beside the engine's
            x8 = torch.from_numpy(requests[:BATCH]).to(dev)
            forward_ms = cuda_ms(lambda: eng._apply(x8), reps=10)
            forward_host_us = host_us(lambda: eng._apply(x8), calls=10)
            prof = profile_batch(eng._apply, x8, "unet int8_fused forward")

    print(f"main path: {main_stats}; launches {launches}")
    served = np.stack(results)
    if served.shape != (len(requests), HW, HW, 1):
        raise AssertionError(f"served shape {served.shape}")
    if not np.isfinite(served).all():
        raise AssertionError("served outputs are not finite")
    if main_stats.padded_slots == 0:
        raise AssertionError("no batch was wrap-padded")
    if min(launches["conv_int8"], launches["upconv_int8"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_paths(launches, {
        "conv_int8": path_counts(conv_sites(),
                                 lambda st: conv_path(st[2], st[3], st[4])),
        "upconv_int8": path_counts(upconv_sites(),
                                   lambda st: upconv_path(st[2], st[3]))},
        main_stats.batches, "serving")

    x = torch.from_numpy(requests).to(dev)
    with torch.no_grad(), fp32_reference():
        y_fp = torch.cat([folded(x[i:i + BATCH])
                          for i in range(0, len(x), BATCH)]).cpu().numpy()
    plain = Int8FusedUNet(q, device=dev, plain=True)
    y_plain = torch.cat([plain(x[i:i + BATCH])
                         for i in range(0, len(x), BATCH)]).cpu().numpy()
    rel_fp, rel_plain = rel_l2(served, y_fp), rel_l2(served, y_plain)
    print(f"served vs float fp32 rel-L2 {rel_fp:.6f} (bound 0.15); "
          f"vs plain versions rel-L2 {rel_plain:.6f} (must be 0: the "
          f"kernels' codes are exact)")
    if not rel_fp < 0.15:
        raise AssertionError(f"served vs float rel-L2 {rel_fp}")
    if rel_plain != 0.0:
        raise AssertionError(f"served vs plain rel-L2 {rel_plain}")
    print(f"engine steady-state slices/s {steady.slices_per_sec:.2f} "
          f"(dp4a design, quoted from PERF.md: "
          f"{DP4A_QUOTED_SLICES['unet']}; batch {BATCH}, "
          f"{steady.requests} "
          f"requests, int8_fused, features {FEATURES}, {HW}x{HW}; {card}); "
          f"batch wall {steady.total_batch_time_s:.4f} s, fetch wait "
          f"{steady.fetch_time_s:.4f} s, assemble "
          f"{steady.assemble_time_s:.4f} s; one forward {forward_ms:.3f} ms "
          f"on the card, {forward_host_us / 1e3:.3f} ms to enqueue")
    return launches, q, {"rel_l2_float": rel_fp, "rel_l2_plain": rel_plain,
                         "slices_per_sec": steady.slices_per_sec,
                         "fetch_time_s": steady.fetch_time_s,
                         "assemble_time_s": steady.assemble_time_s,
                         "total_batch_time_s": steady.total_batch_time_s,
                         "requests": steady.requests,
                         "forward_ms": forward_ms,
                         "forward_host_us": forward_host_us, "profile": prof}


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
    for shape in SSIM_SHAPES:
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
        reset_counts(conv2d_int8, upconv2x2_int8)
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
                    **launch_counts(conv2d_int8, upconv2x2_int8)}
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
    if min(launches[k] for k in ("ssim", "conv_int8", "upconv_int8")) <= 0:
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


def diffusion_gn_sites():
    """(name, H, C) of the 10 int8-emitting K3 launches of one full-width int8_deep
    Fast-DDPM forward: the GroupNorms that feed a quantized conv."""
    f, h1, h2, h3 = FEATURES, HW // 2, HW // 4, HW // 8
    return [("enc2/norm1", h1, 2 * f), ("enc2/norm2", h1, 4 * f),
            ("enc3/norm1", h2, 4 * f), ("enc3/norm2", h2, 8 * f),
            ("bottleneck/norm1", h3, 8 * f), ("bottleneck/norm2", h3, 8 * f),
            ("dec3/norm1", h2, 12 * f), ("dec3/norm2", h2, 4 * f),
            ("dec2/norm1", h1, 6 * f), ("dec2/norm2", h1, 2 * f)]


def diffusion_float_gn_sites():
    """(name, H, C) of the 5 GroupNorm+SiLU sites of one int8_deep forward
    that feed a float conv (256^2): K3's bf16 mode with gn_impl 'fused',
    gn_silu_chain with 'chain'."""
    f = FEATURES
    return [("enc1/norm1", HW, f), ("enc1/norm2", HW, 2 * f),
            ("dec1/norm1", HW, 3 * f), ("dec1/norm2", HW, f),
            ("final_norm", HW, f)]


def diffusion_conv_sites():
    """(name, H, Ci, Co, k) of the 14 kernel-A launches of one int8_deep
    forward (10 3x3, 4 1x1 skip)."""
    f, h1, h2, h3 = FEATURES, HW // 2, HW // 4, HW // 8
    sites = []
    for blk, h, ci, co in (("enc2", h1, 2 * f, 4 * f),
                           ("enc3", h2, 4 * f, 8 * f),
                           ("bottleneck", h3, 8 * f, 8 * f),
                           ("dec3", h2, 12 * f, 4 * f),
                           ("dec2", h1, 6 * f, 2 * f)):
        sites += [(f"{blk}/conv1", h, ci, co, 3), (f"{blk}/conv2", h, co, co, 3)]
        if ci != co:
            sites.append((f"{blk}/skip", h, ci, co, 1))
    return sites


def diffusion_quant_sites(f: int = FEATURES, hw: int = HW):
    """(name, H, C) of the 6 quantizer launches of one int8_deep forward of
    the notebook net at base ``f`` on ``hw``^2 maps: the int8 convs' inputs
    that K3 does not emit (the skips read their block's input; the
    upconvs)."""
    return [("enc2/skip", hw // 2, 2 * f), ("enc3/skip", hw // 4, 4 * f),
            ("upconv3", hw // 8, 8 * f), ("dec3/skip", hw // 4, 12 * f),
            ("upconv2", hw // 4, 4 * f), ("dec2/skip", hw // 2, 6 * f)]


def diffusion_upconv_sites():
    """(name, H_in, C, Co) of kernel B's float-mode launches."""
    f = FEATURES
    return [("upconv3", HW // 8, 8 * f, 4 * f), ("upconv2", HW // 4, 4 * f, 2 * f)]


def k3_phase(dev):
    """K3 at the 10 fused sites, kernel A at the 14 diffusion sites
    (float epilogue, no ReLU) and kernel B's float mode at upconv3 and
    upconv2: each against its plain version on the card, then timed at the
    serving batch."""
    import torch.nn.functional as F

    from mrisr_tpu_torch.device import sm_count
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv2d_int8_plain, conv_path, pack_conv)
    from mrisr_tpu_torch.ops.groupnorm import (
        groupnorm_silu, groupnorm_silu_plain, plan)
    from mrisr_tpu_torch.ops.upconv import (
        pack_upconv, upconv2x2_int8, upconv2x2_int8_plain, upconv_path)
    from mrisr_tpu_torch.serve.quant_diffusion import gn_silu_chain

    g = torch.Generator(device=dev).manual_seed(4321)
    sms = sm_count(dev)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo

    # 64 MiB write between K3 launches: a site's input was written by the
    # conv before it, but most of it no longer sits in the 50 MB L2
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    rows = []
    for name, h, c in diffusion_gn_sites():
        groups = c // 4
        gamma, beta = 1 + 0.5 * torch.randn(c, generator=g, device=dev), (
            0.2 * torch.randn(c, generator=g, device=dev))

        def act(n):
            return (3 * torch.randn((n, h, h, c), generator=g, device=dev)
                    + 0.5).to(torch.bfloat16)

        x = act(CHECK_BATCH)
        ref = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                                   out_dtype=torch.float32)
        scale = (ref.abs().amax() / 127).reshape(1)
        q = groupnorm_silu(x, gamma, beta, num_groups=groups, quant_scale=scale)
        torch.cuda.synchronize()
        want = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                                    quant_scale=scale)
        diff = (q.int() - want.int()).abs()
        worst, off1 = int(diff.max()), float((diff == 1).float().mean())
        if worst > 1 or off1 >= 1e-3:
            raise AssertionError(f"K3 {name}: codes differ: max {worst}, "
                                 f"{off1:.4%} off by 1")
        if not torch.equal(groupnorm_silu(x, gamma, beta, num_groups=groups,
                                          quant_scale=scale), q):
            raise AssertionError(f"K3 {name}: two launches differ")
        y16 = groupnorm_silu(x, gamma, beta, num_groups=groups)
        err = (y16.float() - ref).abs()
        err16 = float(err.max())
        # one bf16 rounding step: 0.03 below |y| = 8 (the JAX package's
        # contract, whose shapes stay below 8), half a bf16 step (2^-9 |y|,
        # with a factor 2 of margin) above, where full-width tails reach
        tol = torch.clamp_min(ref.abs() * 2.0 ** -8, GN_BF16_ATOL)
        if bool((err > tol).any()):
            raise AssertionError(f"K3 {name}: bf16 output off by {err16} "
                                 f"(worst {float((err / tol).max()):.3f} of "
                                 "its tolerance)")

        x = act(BATCH)
        ms = cuda_ms(lambda: groupnorm_silu(x, gamma, beta, num_groups=groups,
                                            quant_scale=scale),
                     reps=20, flush=scrub.zero_)
        plain_ms = cuda_ms(lambda: groupnorm_silu_plain(
            x, gamma, beta, num_groups=groups, quant_scale=scale), reps=3,
            warmup=1, flush=scrub.zero_)
        # yardstick: PyTorch's GroupNorm alone (no SiLU, no quantize) on the
        # channels_last view, bf16 in and out
        xl, gb, bb = x.permute(0, 3, 1, 2), gamma.bfloat16(), beta.bfloat16()
        lib_ms = cuda_ms(lambda: F.group_norm(xl, groups, gb, bb, 1e-5),
                         reps=20, flush=scrub.zero_)
        elems = BATCH * h * h * c
        t_ops = GN_OPS_PER_ELEM * elems / PEAK_FP32_OPS * 1e3
        t_bytes = (3 * elems + 8 * c + 4) / PEAK_BYTES * 1e3
        p = plan(BATCH, h * h, c, x.element_size(), sms)
        rows.append({"kernel": "groupnorm_silu", "site": name, "H": h, "C": c,
                     "batch": BATCH, "max_abs_err": float(worst),
                     "off_by_one": off1, "bf16_err": err16, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
                     "bytes_ms": t_bytes,
                     "form": "one-read" if p.one_read else "two-read",
                     "samples_a_pass": p.spp, "passes": p.passes})

    # K3's bf16 mode at the float sites, beside the chain it replaces
    for name, h, c in diffusion_float_gn_sites():
        groups = c // 4
        gamma, beta = 1 + 0.5 * torch.randn(c, generator=g, device=dev), (
            0.2 * torch.randn(c, generator=g, device=dev))
        x = (3 * torch.randn((BATCH, h, h, c), generator=g, device=dev)
             + 0.5).to(torch.bfloat16)
        y16 = groupnorm_silu(x, gamma, beta, num_groups=groups)
        chain = gn_silu_chain(x, gamma, beta, groups, torch.bfloat16)
        diff = float((y16.float() - chain.float()).abs().max())
        ms = cuda_ms(lambda: groupnorm_silu(x, gamma, beta, num_groups=groups),
                     reps=20, flush=scrub.zero_)
        chain_ms = cuda_ms(lambda: gn_silu_chain(x, gamma, beta, groups,
                                                 torch.bfloat16),
                           reps=5, flush=scrub.zero_)
        elems = BATCH * h * h * c
        t_bytes = (4 * elems + 8 * c) / PEAK_BYTES * 1e3
        t_ops = (GN_OPS_PER_ELEM - 3) * elems / PEAK_FP32_OPS * 1e3
        p = plan(BATCH, h * h, c, x.element_size(), sms)
        rows.append({"kernel": "groupnorm_silu bf16 (float site)",
                     "site": name, "H": h, "C": c, "batch": BATCH,
                     "ms": ms, "chain_ms": chain_ms, "max_abs_diff": diff,
                     "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
                     "bytes_ms": t_bytes,
                     "form": "one-read" if p.one_read else "two-read",
                     "samples_a_pass": p.spp, "passes": p.passes})

    # K3 with a shift at the forward's norm2 sites (the time projection
    # added as x is read), beside the same launch without one
    float_norms = {n for n, _, _ in diffusion_float_gn_sites()}
    for name, h, c in diffusion_gn_sites() + diffusion_float_gn_sites():
        if not name.endswith("norm2"):
            continue
        groups = c // 4
        gamma, beta = 1 + 0.5 * torch.randn(c, generator=g, device=dev), (
            0.2 * torch.randn(c, generator=g, device=dev))

        def case(n):
            return ((3 * torch.randn((n, h, h, c), generator=g, device=dev)
                     + 0.5).to(torch.bfloat16),
                    torch.randn((n, c), generator=g, device=dev))

        x, shift = case(CHECK_BATCH)
        kw = dict(num_groups=groups, shift=shift)
        ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32,
                                   **kw)
        if name not in float_norms:
            kw["quant_scale"] = (ref.abs().amax() / 127).reshape(1)
        got = groupnorm_silu(x, gamma, beta, **kw)
        torch.cuda.synchronize()
        if name in float_norms:
            err = (got.float() - ref).abs()
            if bool((err > torch.clamp_min(ref.abs() * 2.0 ** -8,
                                           GN_BF16_ATOL)).any()):
                raise AssertionError(f"K3 shift {name}: bf16 output off by "
                                     f"{float(err.max())}")
        elif not torch.equal(got, groupnorm_silu_plain(x, gamma, beta, **kw)):
            raise AssertionError(f"K3 shift {name}: codes differ from the "
                                 "plain version's")
        x, shift = case(DDPM_BATCH)  # the Fast-DDPM cells' serving batch
        kw["shift"] = shift
        shift_ms = cuda_ms(lambda: groupnorm_silu(x, gamma, beta, **kw),
                           reps=20, flush=scrub.zero_)
        kw.pop("shift")
        plain_k3_ms = cuda_ms(lambda: groupnorm_silu(x, gamma, beta, **kw),
                              reps=20, flush=scrub.zero_)
        rows.append({"kernel": "groupnorm_silu shift", "site": name, "H": h,
                     "C": c, "batch": DDPM_BATCH,
                     "out": "bf16" if name in float_norms else "int8",
                     "shift_ms": shift_ms, "no_shift_ms": plain_k3_ms})

    for name, h, ci, co, k in diffusion_conv_sites():
        wp = pack_conv(codes((k, k, ci, co)))
        s = uniform(co, 0.3, 2.3) / (127 * 127 / 3 * (k * k * ci) ** 0.5)
        b = uniform(co, -0.5, 0.5)

        def run(x):
            return conv2d_int8(x, wp, s, b, relu=False, out_float=True)

        x = codes((CHECK_BATCH, h, h, ci))
        got = run(x)
        torch.cuda.synchronize()
        want = conv2d_int8_plain(x, wp, s, b, relu=False, out_float=True)
        err = check_exact(got, want, run(x), f"diffusion {name}")
        x = codes((BATCH, h, h, ci))
        plain_ms = cuda_ms(lambda: conv2d_int8_plain(
            x, wp, s, b, relu=False, out_float=True), reps=3, warmup=1)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wp.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: F.conv2d(xb, wb, padding=k // 2), reps=20)
        m = BATCH * h * h
        row = {"kernel": "conv_int8", "site": f"diffusion {name}", "H": h,
               "Ci": ci, "Co": co, "k": k, "batch": BATCH,
               "path": conv_path(ci, co, k), "max_abs_err": err,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "ops": 2.0 * m * co * k * k * ci,
               "bytes": m * ci + co * k * k * ci + 8 * co + 4 * m * co}
        site_timing(row, lambda: run(x), scrub)
        rows.append(row)

    for name, h, c, co in diffusion_upconv_sites():
        w2, s4, b4 = pack_upconv(codes((2, 2, c, co)),
                                 uniform(co, 0.3, 2.3) / (127 * 127 / 3
                                                          * c ** 0.5),
                                 uniform(co, -0.5, 0.5))

        def run(x):
            return upconv2x2_int8(x, w2, s4, b4, out_float=True)

        x = codes((CHECK_BATCH, h, h, c))
        got = run(x)
        torch.cuda.synchronize()
        want = upconv2x2_int8_plain(x, w2, s4, b4, out_float=True)
        err = check_exact(got, want, run(x), f"diffusion {name}")
        x = codes((BATCH, h, h, c))
        plain_ms = cuda_ms(lambda: upconv2x2_int8_plain(
            x, w2, s4, b4, out_float=True), reps=3, warmup=1)
        x2 = x.reshape(-1, c)
        try:
            lib_ms = cuda_ms(lambda: torch._int_mm(x2, w2), reps=20)
        except RuntimeError as e:
            print(f"{name}: torch._int_mm yardstick unavailable: {e}")
            lib_ms = None
        m = BATCH * h * h
        row = {"kernel": "upconv_int8", "site": f"diffusion {name}", "H": h,
               "C": c, "Co": co, "batch": BATCH, "path": upconv_path(c, co),
               "max_abs_err": err, "plain_ms": plain_ms, "library_ms": lib_ms,
               "ops": 2.0 * m * c * 4 * co,
               "bytes": m * c + 4 * co * c + 32 * co + 16 * m * co}
        site_timing(row, lambda: run(x), scrub)
        rows.append(row)

    for r in rows:
        if r["kernel"] == "groupnorm_silu":
            print(f"{r['kernel']:14s} {r['site']:26s} {r['form']} "
                  f"{r['samples_a_pass']} a pass x {r['passes']} err "
                  f"{r['max_abs_err']:.3g} ms {r['ms']:.4f} bound "
                  f"{r['bound_ms']:.4f} plain {r['plain_ms']:.3f} lib "
                  f"{r['library_ms']}")
        elif r["kernel"] == "groupnorm_silu shift":
            print(f"K3 shift {r['site']:18s} {r['H']}^2 x {r['C']} "
                  f"{r['out']} batch {r['batch']}: {r['shift_ms']:.4f} ms "
                  f"with the shift, {r['no_shift_ms']:.4f} without "
                  f"({r['shift_ms'] / r['no_shift_ms']:.4f}x)")
        elif r["kernel"].startswith("groupnorm_silu bf16"):
            print(f"K3 bf16 at float site {r['site']:12s} (C {r['C']}) "
                  f"{r['form']} {r['samples_a_pass']} a pass x "
                  f"{r['passes']}: ms {r['ms']:.4f} vs gn_silu_chain "
                  f"{r['chain_ms']:.4f} (bound {r['bound_ms']:.4f}); max "
                  f"|K3 - chain| {r['max_abs_diff']:.4g}")
        else:
            print_site(r)
    sel = [r for r in rows if r["kernel"] == "groupnorm_silu shift"]
    print(f"K3 at the {len(sel)} norm2 sites (batch {DDPM_BATCH}): "
          f"{sum(r['shift_ms'] for r in sel):.4f} ms with the shift, "
          f"{sum(r['no_shift_ms'] for r in sel):.4f} without")
    sel = [r for r in rows if r["kernel"].startswith("groupnorm_silu bf16")]
    print(f"float GroupNorm sites of one forward (batch {BATCH}): K3 bf16 "
          f"{sum(r['ms'] for r in sel):.4f} ms, gn_silu_chain "
          f"{sum(r['chain_ms'] for r in sel):.4f} ms")
    for kernel in ("groupnorm_silu", "conv_int8", "upconv_int8"):
        sel = [r for r in rows if r["kernel"] == kernel]
        print(f"{kernel}: {len(sel)} launches per int8_deep forward (batch "
              f"{BATCH}): ms {sum(r['ms'] for r in sel):.4f}, bound "
              f"{sum(r['bound_ms'] for r in sel):.4f}, plain "
              f"{sum(r['plain_ms'] for r in sel):.3f}")
    return rows


def seeded_fastddpm(seed: int):
    """FastDDPMUNet at the fastddpm preset's width (base 64, time_dim 128),
    PyTorch's default init under ``seed`` and non-trivial GroupNorm
    scales and shifts."""
    from torch import nn

    from mrisr_tpu_torch.models.diffusion import FastDDPMUNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastDDPMUNet(base_features=FEATURES, time_dim=128)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return model.eval()


def rel_rmse(a: np.ndarray, ref: np.ndarray) -> float:
    """RMS difference over the reference's spread
    (``tests/test_quant_diffusion.py``'s sampler metric)."""
    a, ref = a.astype(np.float64), ref.astype(np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / (ref.std() + 1e-8))


def profile_batch(apply, x, label: str):
    """Device time by kernel over one sampler call (``torch.profiler``);
    returns (device busy ms, wall ms) or None when the profiler shows no
    device time.  A measurement, not a check."""
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apply(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:  # the profiler is untried on this machine
        print(f"profile {label}: unavailable ({type(e).__name__}: {e})")
        return None
    busy = sum(e.device_time_total for e in events) / 1e3
    if busy <= 0:
        print(f"profile {label}: no device time recorded")
        return None
    print(f"profile {label}: device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall ({busy / wall:.1%}); top kernels:")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    return {"busy_ms": busy, "wall_ms": wall,
            "top": [(e.key[:90], e.device_time_total / 1e3, e.count)
                    for e in sorted(events,
                                    key=lambda e: -e.device_time_total)[:10]]}


def diffusion_phase(dev, card: str):
    """The port's Fast-DDPM serving path at full width (see the module
    docstring, item 7).  Returns (launches, results)."""
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
    from mrisr_tpu_torch.config import DataConfig
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv_path)
    from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8, upconv_path
    from mrisr_tpu_torch.serve import (
        engine_from_bundle, load_bundle, make_bundle_apply)

    walls, results = {}, {}
    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        models_dir = os.path.join(work, "models")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(EVAL_PATIENTS),
                  "--slices", str(EVAL_SLICES), "--size", str(HW)])
        model = seeded_fastddpm(0)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != FASTDDPM_PARAMS:
            raise AssertionError(f"FastDDPMUNet has {n_params} parameters")
        os.makedirs(models_dir)
        torch.save(reference_checkpoint(model, "fastddpm", epoch=0,
                                        val_loss=1.0),
                   os.path.join(models_dir, "fastddpm_best.pt"))
        walls["set-up (synth + checkpoint)"] = time.perf_counter() - t0
        common = ["--model", "fastddpm", "--data", store_dir,
                  "--checkpoint-dir", models_dir, "--features", str(FEATURES),
                  "--image-size", str(HW), "--batch-size", str(BATCH),
                  "--device", str(dev)]
        bundles = {}
        for quant in ("int8_deep", "none"):
            bundles[quant] = os.path.join(work, f"bundle_{quant}")
            t0 = time.perf_counter()
            cli.main(["export-serving", *common, "--quant", quant,
                      "--calib-batches", "2", "--out", bundles[quant]])
            walls[f"export-serving {quant}"] = time.perf_counter() - t0
        # requests: [pre, post] of the first test-split triplets
        loader = build_loader(VolumeStore.open(store_dir), "test",
                              DataConfig(batch_size=BATCH,
                                         image_size=(HW, HW)), device=dev)
        conds = []
        for batch in loader:
            conds += list(batch[..., :2].cpu().numpy())
            if len(conds) >= DIFF_REQUESTS:
                break
        requests = np.stack(conds[:DIFF_REQUESTS])

        # --- the main path: counts from 0, two client threads
        with engine_from_bundle(bundles["int8_deep"], batch_size=BATCH,
                                device=dev, gn_impl="fused") as eng:
            eng.predict(requests[0])  # warm-up: allocator, pinned buffers
            eng.reset_stats()
            inner, kept = eng._apply, []

            def capture(x):  # the batches as the engine formed them
                y = inner(x)
                kept.append((x.clone(), y.clone()))
                return y

            eng._apply = capture
            reset_counts(conv2d_int8, upconv2x2_int8)
            futures = [[], []]

            def client(k):
                futures[k] = [eng.submit(r) for r in requests[k::2]]

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            served = [None] * len(requests)
            for k in range(2):
                for j, fut in enumerate(futures[k]):
                    served[k + 2 * j] = fut.result(timeout=600)
            launches = {"groupnorm_silu": groupnorm_silu.launches,
                        "groupnorm_silu/shift": groupnorm_silu.launches_shift,
                        **launch_counts(conv2d_int8, upconv2x2_int8)}
            main_stats = eng.stats
            eng._apply = inner
        print(f"diffusion main path: {main_stats}; launches {launches}")
        served = np.stack(served)
        if served.shape != (len(requests), HW, HW, 1):
            raise AssertionError(f"served shape {served.shape}")
        if not np.isfinite(served).all():
            raise AssertionError("served samples are not finite")
        if main_stats.padded_slots == 0:
            raise AssertionError("no batch was wrap-padded")
        per_batch = {"groupnorm_silu": 150,
                     "groupnorm_silu/shift": 10 * NOTEBOOK_SHIFTED,
                     "conv_int8": 140,
                     "upconv_int8": 20,
                     "quantize_int8": 10 * len(diffusion_quant_sites()),
                     "bias_residual": 10 * NOTEBOOK_E[0],
                     "bias_residual/residual": 10 * NOTEBOOK_E[1],
                     }  # 10 steps x (15, 7, 14, 2, 6, 4, 2)
        for name, n in per_batch.items():
            if launches[name] != n * main_stats.batches:
                raise AssertionError(
                    f"{name}: {launches[name]} launches for "
                    f"{main_stats.batches} batches, want {n} a batch")
        steps = 10  # one forward a sampler step
        check_paths(launches, {
            "conv_int8": path_counts(
                diffusion_conv_sites(),
                lambda st: conv_path(st[2], st[3], st[4])),
            "upconv_int8": path_counts(
                diffusion_upconv_sites(),
                lambda st: upconv_path(st[2], st[3]))},
            steps * main_stats.batches, "diffusion")

        # the served batches against the bf16 float sampler and against the
        # same tables through the plain versions (same conds, same noise:
        # each call seeds its generator with 0)
        float_apply = make_bundle_apply(*load_bundle(bundles["none"]), dev)
        plain_apply = make_bundle_apply(*load_bundle(bundles["int8_deep"]),
                                        dev, gn_impl="fused", plain=True)
        got = np.concatenate([y.cpu().numpy() for _, y in kept])
        y_float = np.concatenate([float_apply(x).cpu().numpy()
                                  for x, _ in kept])
        y_plain = np.concatenate([plain_apply(x).cpu().numpy()
                                  for x, _ in kept])
        rel_float, rel_plain = rel_rmse(got, y_float), rel_l2(got, y_plain)
        print(f"int8_deep sampler vs bf16 float sampler rel-RMSE "
              f"{rel_float:.6f} (bound 0.35); vs plain versions rel-L2 "
              f"{rel_plain:.6f} (must be 0); |sample| max "
              f"{np.abs(got).max():.4g}, std {got.std():.4g}")
        if not rel_float < 0.35:
            raise AssertionError(f"int8 vs float sampler rel-RMSE {rel_float}")
        if rel_plain != 0.0:
            raise AssertionError(f"int8 vs plain versions rel-L2 {rel_plain}")
        results.update(rel_rmse_float=rel_float, rel_l2_plain=rel_plain,
                       batches=main_stats.batches, launches=launches)

        # --- steady state of the three setups, and one profiled batch each
        x8 = torch.from_numpy(requests[np.arange(BATCH) % len(requests)]).to(
            dev)
        for setup, path, gn in (("int8_deep fused", bundles["int8_deep"],
                                 "fused"),
                                ("int8_deep chain", bundles["int8_deep"],
                                 "chain"),
                                ("none (bf16)", bundles["none"], None)):
            with engine_from_bundle(path, batch_size=BATCH, device=dev,
                                    gn_impl=gn) as eng:
                eng.predict(requests[0])
                eng.reset_stats()
                burst = [eng.submit(requests[i % len(requests)])
                         for i in range(STEADY_BATCHES * BATCH)]
                for fut in burst:
                    fut.result(timeout=600)
                st = eng.stats
                batch_ms = cuda_ms(lambda: eng._apply(x8), reps=3, warmup=1)
                prof = profile_batch(eng._apply, x8, setup)
            print(f"{setup}: steady-state slices/s {st.slices_per_sec:.2f} "
                  f"(dp4a design, quoted from PERF.md: "
                  f"{DP4A_QUOTED_SLICES[setup]}; {st.requests} "
                  f"requests, {st.batches} batches of "
                  f"{BATCH}); batch wall {st.total_batch_time_s:.3f} s, "
                  f"fetch wait {st.fetch_time_s:.3f} s, assemble "
                  f"{st.assemble_time_s:.4f} s; one sampler call (10 steps, "
                  f"batch {BATCH}) {batch_ms:.2f} ms on the card ({card})")
            results[setup] = {"slices_per_sec": st.slices_per_sec,
                              "requests": st.requests,
                              "total_batch_time_s": st.total_batch_time_s,
                              "fetch_time_s": st.fetch_time_s,
                              "assemble_time_s": st.assemble_time_s,
                              "batch_ms": batch_ms, "profile": prof}
    print("diffusion wall (s): " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in walls.items()))
    results["wall_s"] = walls
    return launches, results


def grad_errors(module, ref):
    """Per-tensor gradient error of ``module`` against ``ref`` (the same
    UNet stepped in float64 on the CPU), by parameter name: the rel-L2 of
    the difference.  A conv bias right before a training-mode BatchNorm has
    a zero gradient in exact arithmetic (the batch mean removes it), so its
    error is its gradient's norm over the same conv weight's."""
    want = {n: p.grad.detach().double() for n, p in ref.named_parameters()}
    out = {}
    for name, p in module.named_parameters():
        got = p.grad.detach().double().cpu()
        conv, _, leaf = name.rpartition(".")
        if leaf == "bias" and conv.endswith((".conv.0", ".conv.3")):
            out[name] = float(got.norm() / want[conv + ".weight"].norm())
        else:
            out[name] = float((got - want[name]).norm() / want[name].norm())
    return out


def stage_split(prof):
    """Device ms of one profiled stage: total over its kernels, the part
    launched by convolution and by BatchNorm or GroupNorm ops (their self
    device time),
    and the rest by difference (a sum of self device time over the other
    CPU events came to more than the stage's kernels on the H100)."""
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    cats = {"conv": 0.0, "bn": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        key = e.key.lower()
        cat = ("conv" if "conv" in key else
               "bn" if ("batch_norm" in key or "var_mean" in key
                        or "group_norm" in key) else None)
        if cat is not None:
            cats[cat] += getattr(e, "self_device_time_total", 0) / 1e3
    cats["other"] = max(total - cats["conv"] - cats["bn"], 0.0)
    return total, cats


def train_step_split(trainer, batch, perceptual_fn, card: str):
    """A torch.profiler split of one combined-loss train step on the card,
    run in six stages, each under its own profile: the UNet forward, the
    MSE, SSIM and Gabor terms (each forward and backward to the
    prediction), the backward through the UNet, the optimizer.  Returns a
    dict of device ms, or None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.losses import mse, ssim_loss

    lcfg = trainer.config.loss
    inputs, target = batch[..., :2], batch[..., 2:3]
    module, state = trainer.state.module.train(), trainer.state
    state.optimizer.zero_grad(set_to_none=True)
    out = {}
    keep = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with fp32_reference():
                keep[name] = fn()
            torch.cuda.synchronize()
        out[name] = stage_split(prof)

    def term(fn, weight):
        return lambda: torch.autograd.grad(
            weight * fn(keep["forward"], target), keep["forward"],
            retain_graph=True)[0]

    try:
        stage("forward", lambda: module(inputs))
        stage("mse term", term(mse, 1.0))
        stage("ssim term", term(lambda p, t: ssim_loss(p[..., 0], t[..., 0]),
                                lcfg.lambda_ssim))
        stage("gabor term", term(perceptual_fn, lcfg.lambda_perceptual))
        stage("backward", lambda: keep["forward"].backward(
            keep["mse term"] + keep["ssim term"] + keep["gabor term"]))
        stage("optimizer", state.apply_gradients)
    except Exception as e:  # the profiler is a measurement, not a check
        print(f"train step split: unavailable ({type(e).__name__}: {e})")
        return None
    if sum(t for t, _ in out.values()) <= 0:
        print("train step split: no device time recorded")
        return None
    split = {
        "forward convs": out["forward"][1]["conv"],
        "backward convs": out["backward"][1]["conv"],
        "BatchNorm (fwd + bwd)": out["forward"][1]["bn"]
        + out["backward"][1]["bn"],
        "other UNet ops (ReLU, pool, concat, copies; fwd + bwd)":
            out["forward"][1]["other"] + out["backward"][1]["other"],
        "MSE term fwd+bwd": out["mse term"][0],
        "SSIM term fwd+bwd": out["ssim term"][0],
        "Gabor term fwd+bwd": out["gabor term"][0],
        "optimizer (Adam)": out["optimizer"][0],
    }
    total = sum(t for t, _ in out.values())
    print(f"one train step split (torch.profiler device ms, batch "
          f"{TRAIN_BATCH}, {HW}x{HW}, features {FEATURES}; {card}): "
          f"total {total:.3f}")
    for k, v in split.items():
        print(f"  {v:9.3f} ms {100 * v / total:5.1f} %  {k}")
    return {"total_ms": total, "split_ms": split,
            "stage_ms": {k: t for k, (t, _) in out.items()}}


def fft_route_check(trainer, batch, step_ms, dev, card: str):
    """The conv routes of ``models/conv.py``: ``dec2.conv.0`` (256 -> 128
    at 128^2, batch 4, channels_last as in the forward) forward and
    backward routed around cuDNN's FFT convolution against cuDNN's own
    choice (outputs within 1e-5, the routed conv at most 20 ms), and the
    whole train step with no route (cuDNN at every conv) beside
    ``step_ms``, the routed step."""
    import torch.nn.functional as F

    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.models import conv as conv_module

    conv = trainer.state.module.dec2.conv[0]
    x = torch.randn(TRAIN_BATCH, 4 * FEATURES, HW // 2, HW // 2,
                    device=dev).contiguous(memory_format=torch.channels_last)
    if conv_module.route(x.shape, conv, True) != "fft":
        raise AssertionError("dec2.conv.0 at batch 4 is not routed")

    def fwd_bwd(routed):
        def fn():
            with fp32_reference():
                leaf = x.detach().requires_grad_(True)
                y = conv(leaf) if routed else F.conv2d(
                    leaf, conv.weight, conv.bias, 1, 1)
                y.sum().backward()
            return y.detach()
        return fn

    diff = float((fwd_bwd(True)() - fwd_bwd(False)()).abs().max())
    routed_ms = cuda_ms(fwd_bwd(True), reps=5, warmup=1)
    cudnn_ms = cuda_ms(fwd_bwd(False), reps=3, warmup=1)
    routes = conv_module.route
    conv_module.route = lambda *args: None
    try:
        no_route_ms = cuda_ms(lambda: trainer.train_step(trainer.state,
                                                         batch),
                              reps=3, warmup=1)
    finally:
        conv_module.route = routes
    print(f"conv routes: dec2.conv.0 fwd+bwd at batch {TRAIN_BATCH} routed "
          f"{routed_ms:.3f} ms, cuDNN's choice {cudnn_ms:.3f} ms, max |diff| "
          f"{diff:.3g} (bound 1e-5); unet_combined train step {step_ms:.3f} "
          f"ms routed, {no_route_ms:.3f} ms with no route ({card})")
    if not diff <= 1e-5:
        raise AssertionError(f"routed dec2.conv.0 differs from cuDNN's by "
                             f"{diff}")
    if not routed_ms <= 20.0:
        raise AssertionError(f"routed dec2.conv.0 takes {routed_ms} ms")
    return {"conv_routed_ms": routed_ms, "conv_cudnn_ms": cudnn_ms,
            "max_abs_diff": diff, "step_routed_ms": step_ms,
            "step_no_route_ms": no_route_ms}


def train_phase(dev, card: str, keep=None, step_ref=None):
    """The port's training path at full width (see the module docstring,
    item 8); the trained ``unet_combined_best.pt`` is copied into ``keep``
    (phase 11's teacher), and the float32 step's batch, its float64 CPU
    module and gradient bounds into the dict ``step_ref`` (phase 16's
    reference).  Returns (launches, results)."""
    import dataclasses

    from mrisr_tpu_torch import cli, fp32_reference
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv_path)
    from mrisr_tpu_torch.ops.ssim import ssim
    from mrisr_tpu_torch.ops.ssim_fused import ssim_fused
    from mrisr_tpu_torch.ops.stats import minmax_normalize
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8, upconv_path
    from mrisr_tpu_torch.serve import Int8FusedUNet, engine_from_bundle
    from mrisr_tpu_torch.serve.bundle import load_bundle
    from mrisr_tpu_torch.train import SupervisedTrainer

    results, walls = {}, {}
    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=TRAIN_BATCH),
        model=dataclasses.replace(base.model, base_features=FEATURES))
    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        models_dir = os.path.join(work, "models")
        results_dir = os.path.join(work, "results")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(TRAIN_PATIENTS),
                  "--slices", str(TRAIN_SLICES), "--size", str(HW)])
        walls["synth"] = time.perf_counter() - t0
        store = VolumeStore.open(store_dir)

        # --- 1. one float32 step on the card and one on the CPU from the
        # same init_model weights and batch (augmentation off), each held
        # against the same step in float64 on the CPU
        t0 = time.perf_counter()
        plain_cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                         augment=False))
        batch = next(iter(build_loader(store, "train", plain_cfg.data,
                                       device="cpu")))
        perceptual = make_perceptual_fn(cfg.loss.perceptual)
        on_card = SupervisedTrainer(plain_cfg, perceptual_fn=perceptual,
                                    device=dev)
        on_cpu = SupervisedTrainer(plain_cfg, perceptual_fn=perceptual,
                                   device="cpu")
        on_ref = SupervisedTrainer(plain_cfg, perceptual_fn=make_perceptual_fn(
            cfg.loss.perceptual, dtype=torch.float64), device="cpu")
        on_ref.state.module.double()
        n_params = sum(p.numel() for p in on_cpu.state.module.parameters())
        for (k, a), b in zip(on_card.state.module.state_dict().items(),
                             on_cpu.state.module.state_dict().values()):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"init differs on the card: {k}")
        _, m_card = on_card.train_step(on_card.state, batch.to(dev))
        _, m_cpu = on_cpu.train_step(on_cpu.state, batch)
        _, m_ref = on_ref.train_step(on_ref.state, batch.double())
        ref_loss = float(m_ref["loss"])
        sides = {"card": on_card, "CPU": on_cpu}
        loss_rel = {s: abs(float(m["loss"]) - ref_loss) / abs(ref_loss)
                    for s, m in (("card", m_card), ("CPU", m_cpu))}
        errs = {s: grad_errors(t.state.module, on_ref.state.module)
                for s, t in sides.items()}
        stats_err = {s: max(
            float((a.cpu().double() - b).abs().max()) for (k, a), b in zip(
                t.state.module.named_buffers(),
                on_ref.state.module.buffers()) if "running" in k)
            for s, t in sides.items()}
        card_cpu = grad_errors(on_card.state.module, on_cpu.state.module)
        walls["card vs CPU step"] = time.perf_counter() - t0
        bound = {n: max(GRAD_RTOL, GRAD_NOISE_FACTOR * e)
                 for n, e in errs["CPU"].items()}
        if step_ref is not None:
            step_ref.update(batch=batch, f64=on_ref.state.module, bound=bound)
        del on_ref
        over = [n for n, e in errs["card"].items() if not e <= bound[n]]
        worst = sorted(errs["card"], key=errs["card"].get, reverse=True)[:5]
        print(f"train step, float32 card and CPU vs float64 CPU ({n_params} "
              f"parameters, batch {TRAIN_BATCH}, {HW}x{HW}): loss "
              f"{ref_loss:.9f}, rel {loss_rel['card']:.3g} card, "
              f"{loss_rel['CPU']:.3g} CPU (bound 1e-4); BN running stats "
              f"max |diff| {stats_err['card']:.3g} card, "
              f"{stats_err['CPU']:.3g} CPU (bound 1e-4); gradient rel-L2 "
              f"over {GRAD_RTOL:g}: {sum(e > GRAD_RTOL for e in errs['card'].values())} "
              f"tensors card, {sum(e > GRAD_RTOL for e in errs['CPU'].values())} "
              f"CPU, of {len(bound)}; card vs CPU directly: loss rel "
              f"{abs(float(m_card['loss']) - float(m_cpu['loss'])) / ref_loss:.3g}, "
              f"worst gradient rel-L2 {max(card_cpu.values()):.3g}")
        for n in worst:
            print(f"  {n}: card {errs['card'][n]:.3g}, CPU "
                  f"{errs['CPU'][n]:.3g}, bound {bound[n]:.3g}")
        if n_params != UNET_PARAMS:
            raise AssertionError(f"UNet has {n_params} parameters")
        if not loss_rel["card"] <= 1e-4:
            raise AssertionError(f"train step loss card vs float64 rel "
                                 f"{loss_rel['card']}")
        if not stats_err["card"] <= 1e-4:
            raise AssertionError(f"BN running stats card vs float64 "
                                 f"{stats_err['card']}")
        if over:
            raise AssertionError(f"gradients past their bound on the card: "
                                 f"{over}")
        results["card_vs_cpu"] = {
            "loss_rel_f64": loss_rel, "bn_stats_err_f64": stats_err,
            "grad_rel_l2_f64": errs, "card_vs_cpu_grad_rel_l2": card_cpu}

        # one train step's device time, busy share and split (the trainer
        # above is a throwaway; its state moves on)
        xb = batch.to(dev)
        step_ms = cuda_ms(lambda: on_card.train_step(on_card.state, xb),
                          reps=5, warmup=1)
        results["fft_route"] = fft_route_check(on_card, xb, step_ms, dev,
                                               card)
        prof = profile_batch(
            lambda x: [on_card.train_step(on_card.state, x)
                       for _ in range(5)], xb, "5 train steps")
        split = train_step_split(on_card, xb, perceptual, card)
        # an epoch with the batches gathered on the card (--scan-epochs)
        loader = build_loader(store, "train", cfg.data, backend="device",
                              device=dev)
        on_card.enable_device_epochs(loader.bank, loader.plan_flat)
        scan = on_card.run_epoch(None, train=True, epoch=1)
        scan_time = on_card.timings[-1]
        if not np.isfinite(scan["loss"]):
            raise AssertionError(f"device-bank epoch loss {scan['loss']}")
        del on_card, on_cpu, loader

        # --- 2. the CLI: train 2 epochs, then resume to 3
        common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                  "--results-dir", results_dir, "--features", str(FEATURES),
                  "--image-size", str(HW), "--device", str(dev)]
        t0 = time.perf_counter()
        trainer = cli.main(["train", "--preset", "unet_combined", *common,
                            "--epochs", "2"])
        walls["cli train 2 epochs"] = time.perf_counter() - t0
        timings = trainer.timings
        losses = trainer.history.series["train_loss"]
        del trainer
        t0 = time.perf_counter()
        resumed = cli.main(["train", "--preset", "unet_combined", *common,
                            "--epochs", "3", "--resume"])
        walls["cli train --resume to 3"] = time.perf_counter() - t0
        start_epoch = resumed.start_epoch
        del resumed
        with open(os.path.join(results_dir,
                               "unet_combined_history.json")) as f:
            hist = json.load(f)
        print(f"train losses {hist['train_loss']}, val losses "
              f"{hist['val_loss']}")
        if not all(np.isfinite(hist["train_loss"] + hist["val_loss"])):
            raise AssertionError("a training loss is not finite")
        if not losses[1] < losses[0]:
            raise AssertionError(f"epoch 2 train loss {losses[1]} not below "
                                 f"epoch 1's {losses[0]}")
        if start_epoch != 3 or hist["epoch"] != [1.0, 2.0, 3.0]:
            raise AssertionError(f"resume started at {start_epoch}, history "
                                 f"epochs {hist['epoch']}")
        want_files = {f"unet_combined_{s}.pt" for s in (
            "best", "latest", "epoch_1", "epoch_2", "epoch_3")}
        if not want_files <= set(os.listdir(models_dir)):
            raise AssertionError(f"checkpoints {os.listdir(models_dir)}")
        if keep is not None:
            shutil.copy(os.path.join(models_dir, "unet_combined_best.pt"),
                        keep)
        want_keys = {"train_loss", "val_loss", "epoch_time_s", "train_mse",
                     "train_ssim", "train_perceptual", "val_mse", "val_ssim",
                     "val_perceptual", "best_val_loss", "config", "timestamp"}
        if not want_keys <= set(hist):
            raise AssertionError(f"history keys {sorted(hist)}")
        ep2 = [t for t in timings if t["train"] and t["epoch"] == 2][0]
        steps_per_s = ep2["steps"] / ep2["seconds"]
        results.update(
            history={k: hist[k] for k in ("train_loss", "val_loss",
                                          "epoch_time_s")},
            epoch2_train={"steps": ep2["steps"], "seconds": ep2["seconds"],
                          "steps_per_s": steps_per_s,
                          "slices_per_s": steps_per_s * TRAIN_BATCH},
            scan_epoch={"steps": scan_time["steps"],
                        "seconds": scan_time["seconds"],
                        "loss": scan["loss"]},
            step_ms=step_ms, profile=prof, split=split)

        # --- 3. the trained checkpoint through K1 (eval) and A, B (serving)
        ssim_fused.launches = 0
        t0 = time.perf_counter()
        cli.main(["eval", "--model", "unet_combined", *common,
                  "--batch-size", str(BATCH)])
        walls["cli eval"] = time.perf_counter() - t0
        launches = {"ssim": ssim_fused.launches}
        with open(os.path.join(results_dir,
                               "unet_combined_test_metrics.json")) as f:
            metrics = json.load(f)
        model = load_model("unet_combined", models_dir, checkpoint="required",
                           cfg=cfg.model, device=dev)
        bank, evals = None, {}
        for dist, label in ((2, "3mm"), (4, "6mm")):
            loader = build_loader(store, "test", dataclasses.replace(
                cfg.data, distance_filter=dist, batch_size=BATCH),
                device=dev, bank=bank)
            bank = loader.bank
            pairs = [(b[..., 2], model.predict_nhwc(b[..., :2])[..., 0])
                     for b in loader]
            gt = torch.cat([g for g, _ in pairs])
            pred = torch.cat([p for _, p in pairs])
            plain = float(ssim(minmax_normalize(gt), minmax_normalize(pred),
                               use_kernel=False).mean())
            got = metrics[label]["ssim_mean"]
            evals[label] = {"ssim_k1": got, "ssim_plain": plain,
                            "psnr": metrics[label]["psnr_mean"],
                            "n": metrics[label]["num_samples"]}
            print(f"trained unet_combined {label}: SSIM {got:.6f} (plain "
                  f"{plain:.6f}, diff {abs(got - plain):.2g}) PSNR "
                  f"{metrics[label]['psnr_mean']:.4f} dB, "
                  f"{metrics[label]['num_samples']} triplets")
            if not (np.isfinite(got) and abs(got - plain) <= SSIM_ATOL):
                raise AssertionError(f"trained eval {label}: K1 {got} vs "
                                     f"plain {plain}")
        if launches["ssim"] <= 0:
            raise AssertionError("K1 was not launched by the trained eval")
        results["eval"] = evals

        bundle = os.path.join(work, "bundle")
        t0 = time.perf_counter()
        cli.main(["export-serving", "--model", "unet_combined", *common,
                  "--quant", "int8_fused", "--batch-size", str(BATCH),
                  "--out", bundle])
        walls["cli export-serving"] = time.perf_counter() - t0
        loader = build_loader(store, "test", dataclasses.replace(
            cfg.data, batch_size=BATCH), device=dev)
        requests = torch.cat([b[..., :2] for b in loader])[:TRAIN_REQUESTS]
        requests = requests.cpu().numpy()
        with engine_from_bundle(bundle, batch_size=BATCH, device=dev) as eng:
            eng.predict(requests[0])
            eng.reset_stats()
            reset_counts(conv2d_int8, upconv2x2_int8)
            served = np.stack([f.result(timeout=600) for f in
                               [eng.submit(r) for r in requests]])
            launches.update(launch_counts(conv2d_int8, upconv2x2_int8))
            stats = eng.stats
        check_paths(launches, {
            "conv_int8": path_counts(conv_sites(),
                                     lambda st: conv_path(st[2], st[3], st[4])),
            "upconv_int8": path_counts(upconv_sites(),
                                       lambda st: upconv_path(st[2], st[3]))},
            stats.batches, "trained serving")
        x = torch.from_numpy(requests).to(dev)
        folded = load_model("unet_combined", models_dir,
                            checkpoint="required", cfg=cfg.model, fold_bn=True,
                            device=dev)
        plain_fwd = Int8FusedUNet(load_bundle(bundle)[0], device=dev,
                                  plain=True)
        with fp32_reference():
            y_fp = torch.cat([folded.predict_nhwc(x[i:i + BATCH])
                              for i in range(0, len(x), BATCH)]).cpu().numpy()
        y_plain = torch.cat([plain_fwd(x[i:i + BATCH]) for i in range(
            0, len(x), BATCH)]).cpu().numpy()
        rel_fp, rel_plain = rel_l2(served, y_fp), rel_l2(served, y_plain)
        print(f"trained int8_fused served vs folded float rel-L2 {rel_fp:.6f} "
              f"(bound 0.15); vs plain versions {rel_plain:.6f} (must be 0); "
              f"{stats.requests} requests in {stats.batches} batches")
        if served.shape != (len(requests), HW, HW, 1) or not np.isfinite(
                served).all():
            raise AssertionError(f"trained serving output {served.shape}")
        if not rel_fp < 0.15:
            raise AssertionError(f"trained served vs float rel-L2 {rel_fp}")
        if rel_plain != 0.0:
            raise AssertionError(f"trained served vs plain rel-L2 {rel_plain}")
        results["serving"] = {"rel_l2_float": rel_fp,
                              "rel_l2_plain": rel_plain,
                              "batches": stats.batches}
    results["launches"], results["wall_s"] = launches, walls
    print(f"train phase launches {launches}")
    e2 = results["epoch2_train"]
    print(f"training (unet_combined, features {FEATURES}, {HW}x{HW}, batch "
          f"{TRAIN_BATCH}, Adam, hflip/vflip, MSE + 0.1 SSIM + 0.1 Gabor; "
          f"{card}): epoch 2 {e2['steps']} steps in {e2['seconds']:.3f} s = "
          f"{e2['steps_per_s']:.3f} steps/s, {e2['slices_per_s']:.3f} "
          f"slices/s; one step {step_ms:.3f} ms on the card; device-bank "
          f"epoch {scan_time['steps']} steps in {scan_time['seconds']:.3f} s")
    if prof is not None:
        print(f"training device busy {prof['busy_ms']:.3f} ms of "
              f"{prof['wall_ms']:.3f} ms over 5 steps "
              f"({prof['busy_ms'] / prof['wall_ms']:.1%}; {card})")
    print("train wall (s): " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in walls.items()))
    return launches, results


FAMILY_PARAMS = {"unet_gan": 31_037_057, "patchgan": 2_765_633,
                 "deepcnn": 11_173_889, "progressive_unet": 93_111_171,
                 "fastddpm": 13_899_905, "fastddpm_simple": 2_162_177}


def make_trainer(preset, cfg, device, dtype=torch.float32):
    """The preset's trainer on ``device``; float64 modules (and Gabor bank)
    for ``dtype`` float64."""
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import (
        DiffusionTrainer, GANTrainer, SupervisedTrainer)

    if cfg.loss.kind == "gan":
        tr = GANTrainer(cfg, make_perceptual_fn(cfg.loss.perceptual,
                                                dtype=dtype), device=device)
        states = {"G": tr.g_state, "D": tr.d_state}
    elif cfg.loss.kind == "diffusion":
        tr = DiffusionTrainer(cfg, device=device)
        states = {"": tr.state}
    else:
        tr = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
            cfg.loss.perceptual, dtype=dtype) if cfg.loss.kind == "combined"
            else None, device=device)
        states = {"": tr.state}
    for st in states.values():
        st.module.to(dtype)
    return tr, states


def family_step_check(preset, cfg, batch, dev, card, worst_2x=False):
    """One float32 train step of ``preset`` on the card and on the CPU from
    the same init_model weights and batch (augmentation off), each held
    against the same step in float64 on the CPU, as phase 8 holds the UNet:
    losses within rel 1e-4, BN running statistics within 1e-4, each
    gradient within max(1e-3, 10x the CPU float32 error on that tensor);
    with ``worst_2x``, the card's worst gradient error at most 2x the
    CPU's worst.  A diffusion step takes fixed draws (the same t and noise
    on every side)."""
    sides = {"card": (dev, torch.float32),
             "CPU": (torch.device("cpu"), torch.float32),
             "f64": (torch.device("cpu"), torch.float64)}
    g = torch.Generator().manual_seed(1)
    b = batch.shape[0]
    t_idx = torch.randint(0, cfg.model.num_inference_steps, (b,),
                          generator=g)
    eps = torch.randn(batch[..., 2:3].shape, generator=g)
    runs = {}
    for side, (device, dtype) in sides.items():
        tr, states = make_trainer(preset, cfg, device, dtype)
        x = batch.to(device, dtype)
        if cfg.loss.kind == "gan":
            metrics = tr.train_step(tr.g_state, tr.d_state, x)[-1]
        elif cfg.loss.kind == "diffusion":
            metrics = tr.train_step.train_on(
                tr.state, x, t_idx.to(device), eps.to(device, dtype))[1]
        else:
            metrics = tr.train_step(tr.state, x)[1]
        runs[side] = ({k: float(v) for k, v in metrics.items()},
                      {n: st.module for n, st in states.items()})
    ref_metrics, ref_modules = runs.pop("f64")
    n_params = sum(p.numel() for m in ref_modules.values()
                   for p in m.parameters())
    out = {"params": n_params}
    for side, (metrics, modules) in runs.items():
        loss_rel = max(abs(metrics[k] - ref_metrics[k]) / abs(ref_metrics[k])
                       for k in ref_metrics if k in ("loss", "g", "d"))
        errs, stats = {}, 0.0
        for name, module in modules.items():
            ref = ref_modules[name]
            errs.update({f"{name}:{k}": v for k, v in grad_errors(
                module, ref).items()})
            stats = max([stats] + [
                float((a.cpu().double() - r.double()).abs().max())
                for (k, a), r in zip(module.named_buffers(), ref.buffers())
                if "running" in k])
        out[side] = {"loss_rel": loss_rel, "bn_stats_err": stats,
                     "grad_rel_l2": errs, "worst": max(errs.values())}
    on_card, on_cpu = out["card"], out["CPU"]
    bound = {n: max(GRAD_RTOL, GRAD_NOISE_FACTOR * e)
             for n, e in on_cpu["grad_rel_l2"].items()}
    over = [n for n, e in on_card["grad_rel_l2"].items() if not e <= bound[n]]
    worst = max(on_card["grad_rel_l2"], key=on_card["grad_rel_l2"].get)
    print(f"{preset} train step, float32 card and CPU vs float64 CPU "
          f"({n_params} parameters, batch {tuple(batch.shape)}; {card}): "
          f"loss rel {on_card['loss_rel']:.3g} card, "
          f"{on_cpu['loss_rel']:.3g} CPU; "
          f"BN stats {on_card['bn_stats_err']:.3g} card, "
          f"{on_cpu['bn_stats_err']:.3g} CPU; worst gradient rel-L2 card "
          f"{on_card['worst']:.3g} ({worst}), CPU {on_cpu['worst']:.3g}; "
          f"{sum(e > GRAD_RTOL for e in on_card['grad_rel_l2'].values())} "
          f"card and "
          f"{sum(e > GRAD_RTOL for e in on_cpu['grad_rel_l2'].values())} "
          f"CPU tensors over {GRAD_RTOL:g}, of {len(bound)}")
    if not on_card["loss_rel"] <= 1e-4:
        raise AssertionError(f"{preset} step loss card vs float64 rel "
                             f"{on_card['loss_rel']}")
    if not on_card["bn_stats_err"] <= 1e-4:
        raise AssertionError(f"{preset} BN stats card vs float64 "
                             f"{on_card['bn_stats_err']}")
    if over:
        raise AssertionError(f"{preset} gradients past their bound on the "
                             f"card: {over}")
    if worst_2x and not on_card["worst"] <= 2 * on_cpu["worst"]:
        raise AssertionError(f"{preset} card's worst gradient "
                             f"{on_card['worst']} over 2x the CPU's "
                             f"{on_cpu['worst']}")
    for side in ("card", "CPU"):
        del out[side]["grad_rel_l2"]
    return out


def profile_step(fn):
    """Device ms of one call of ``fn`` by op kind (``stage_split``), or
    None when the profiler records no device time.  A measurement."""
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total, cats = stage_split(prof)
    except Exception as e:  # the profiler is a measurement, not a check
        print(f"step split: unavailable ({type(e).__name__}: {e})")
        return None
    return None if total <= 0 else {"total": total, **cats}


def count_launches(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before it;
    returns (fn's result, the counts just after)."""
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu
    from mrisr_tpu_torch.ops.ssim_fused import ssim_fused
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8

    ssim_fused.launches = 0
    reset_counts(conv2d_int8, upconv2x2_int8)
    result = fn()
    return result, {"ssim": ssim_fused.launches,
                    "groupnorm_silu": groupnorm_silu.launches,
                    **launch_counts(conv2d_int8, upconv2x2_int8)}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def eval_against_plain(preset, model, store, data_cfg, metrics):
    """Each eval number K1 gave (SSIM per spacing, or per stage for the
    progressive model) against the plain SSIM of the same predictions."""
    import dataclasses

    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.ops.ssim import ssim
    from mrisr_tpu_torch.ops.stats import minmax_normalize

    def plain(gt, pred):
        return float(ssim(minmax_normalize(gt), minmax_normalize(pred),
                          use_kernel=False).mean())

    out = {}
    if model.kind == "window":
        loader = build_loader(store, "test", dataclasses.replace(
            data_cfg, batch_size=BATCH, augment=False), kind="window",
            device=model.device)
        preds = {k: [] for k in ("i1", "i2", "i3")}
        gts = {k: [] for k in preds}
        for b in loader:
            for (k, ch), p in zip((("i1", 1), ("i2", 2), ("i3", 3)),
                                  model.predict_nhwc(b)):
                preds[k].append(p[..., 0])
                gts[k].append(b[..., ch])
        pairs = {k: (torch.cat(gts[k]), torch.cat(preds[k])) for k in preds}
    else:
        pairs, bank = {}, None
        for dist, label in ((2, "3mm"), (4, "6mm")):
            loader = build_loader(store, "test", dataclasses.replace(
                data_cfg, distance_filter=dist, batch_size=BATCH,
                augment=False), device=model.device, bank=bank)
            bank = loader.bank
            got = [(b[..., 2], model.predict_nhwc(b[..., :2])[..., 0])
                   for b in loader]
            pairs[label] = (torch.cat([g for g, _ in got]),
                            torch.cat([p for _, p in got]))
    for label, (gt, pred) in pairs.items():
        k1, want = metrics[label]["ssim_mean"], plain(gt, pred)
        out[label] = {"ssim_k1": k1, "ssim_plain": want,
                      "psnr": metrics[label]["psnr_mean"],
                      "n": metrics[label]["num_samples"]}
        print(f"trained {preset} {label}: SSIM {k1:.6f} (plain {want:.6f}, "
              f"diff {abs(k1 - want):.2g}) PSNR "
              f"{metrics[label]['psnr_mean']:.4f} dB, "
              f"{metrics[label]['num_samples']} samples")
        if not (np.isfinite(k1) and abs(k1 - want) <= SSIM_ATOL):
            raise AssertionError(f"trained {preset} eval {label}: K1 {k1} vs "
                                 f"plain {want}")
    return out


def serve_trained(preset, bundle, requests, dev, models_dir, mcfg,
                  features=FEATURES, steps=10):
    """Serve ``requests`` through ``engine_from_bundle`` (batch 8); the
    served output against the same tables through the plain versions
    (must be equal) and against the float model (the folded forward of a
    UNet of width ``features``, or the float32 sampler of ``steps`` steps
    on the same noise).  Returns (results, counts)."""
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ops.conv_int8 import conv_path
    from mrisr_tpu_torch.ops.upconv import upconv_path
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, engine_from_bundle, load_bundle, make_bundle_apply)

    diffusion = preset.startswith("fastddpm")
    with engine_from_bundle(bundle, batch_size=BATCH, device=dev,
                            **({"gn_impl": "fused"} if diffusion else {})
                            ) as eng:
        eng.predict(requests[0])
        eng.reset_stats()
        inner, kept = eng._apply, []

        def capture(x):  # the batches as the engine formed them
            y = inner(x)
            kept.append((x.clone(), y.clone()))
            return y

        eng._apply = capture
        served, counts = count_launches(lambda: np.stack([
            f.result(timeout=600) for f in [eng.submit(r)
                                            for r in requests]]))
        stats = eng.stats
        eng._apply = inner
    forwards = stats.batches * (steps if diffusion else 1)
    if diffusion:
        for name, n in {"groupnorm_silu": 15, "conv_int8": 14,
                        "upconv_int8": 2}.items():
            if counts[name] != n * forwards:
                raise AssertionError(f"trained {preset} {name}: "
                                     f"{counts[name]} launches for "
                                     f"{forwards} forwards, want {n} each")
        check_paths(counts, {
            "conv_int8": path_counts(diffusion_conv_sites(), lambda st:
                                     conv_path(st[2], st[3], st[4])),
            "upconv_int8": path_counts(diffusion_upconv_sites(), lambda st:
                                       upconv_path(st[2], st[3]))},
            forwards, f"trained {preset} serving")
        plain_apply = make_bundle_apply(*load_bundle(bundle), dev,
                                        gn_impl="fused", plain=True)
        model = load_model(preset, models_dir, checkpoint="required",
                           cfg=mcfg, device=dev)
        float_fn, plain_fn = model.predict_nhwc, plain_apply
    else:
        check_paths(counts, {
            "conv_int8": path_counts(conv_sites(features), lambda st:
                                     conv_path(st[2], st[3], st[4])),
            "upconv_int8": path_counts(upconv_sites(features), lambda st:
                                       upconv_path(st[2], st[3]))},
            forwards, f"trained {preset} serving")
        model = load_model(preset, models_dir, checkpoint="required",
                           cfg=mcfg, fold_bn=True, device=dev)
        float_fn = model.predict_nhwc
        plain_fn = Int8FusedUNet(load_bundle(bundle)[0], device=dev,
                                 plain=True)
    got = np.concatenate([y.cpu().numpy() for _, y in kept])
    with fp32_reference():
        y_float = np.concatenate([float_fn(x).cpu().numpy()
                                  for x, _ in kept])
    y_plain = np.concatenate([plain_fn(x).cpu().numpy() for x, _ in kept])
    rel_float = (rel_rmse if diffusion else rel_l2)(got, y_float)
    rel_plain = rel_l2(got, y_plain)
    metric, bound = (("rel-RMSE", 0.35) if diffusion else ("rel-L2", 0.15))
    print(f"trained {preset} served ({stats.requests} requests, "
          f"{stats.batches} batches of {BATCH}): vs the float model "
          f"{metric} {rel_float:.6f} (bound {bound}); vs plain versions "
          f"rel-L2 {rel_plain:.6f} (must be 0); launches {counts}")
    if served.shape != (len(requests), HW, HW, 1) or not np.isfinite(
            served).all():
        raise AssertionError(f"trained {preset} serving output "
                             f"{served.shape}")
    if not rel_float < bound:
        raise AssertionError(f"trained {preset} served vs float {rel_float}")
    if rel_plain != 0.0:
        raise AssertionError(f"trained {preset} served vs plain {rel_plain}")
    return {"float_" + metric: rel_float, "rel_l2_plain": rel_plain,
            "batches": stats.batches}, counts


def families_phase(dev, card: str, keep=None):
    """Training of the five other families at full width (see the module
    docstring, item 9); the trained ``fastddpm_best.pt`` (phase 11's
    teacher), ``deepcnn_best.pt`` and ``progressive_unet_best.pt`` (phase
    12's models) are copied into ``keep``.  Returns (launches, results)."""
    import dataclasses

    import torch.nn.functional as F

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.models.registry import init_model

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()
    for name, want in FAMILY_PARAMS.items():
        got = sum(p.numel() for p in init_model(name)[0].parameters())
        if got != want:
            raise AssertionError(f"{name} has {got} parameters, want {want}")

    def preset_cfg(preset, hw=HW, batch=TRAIN_BATCH):
        base = PRESETS[preset]
        return base.replace(
            data=dataclasses.replace(base.data, image_size=(hw, hw),
                                     batch_size=batch, augment=False),
            model=dataclasses.replace(base.model, base_features=FEATURES))

    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(FAMILY_PATIENTS),
                  "--slices", str(FAMILY_SLICES), "--size", str(HW)])
        store = VolumeStore.open(store_dir)
        walls["synth"] = time.perf_counter() - t0

        def first_batch(cfg, kind="triplet"):
            return next(iter(build_loader(store, "train", cfg.data,
                                          kind=kind, device="cpu")))

        # --- card vs CPU, each against float64: the GAN and the Fast-DDPM
        # at full size, the other three at 64^2 and batch 2 (their float64
        # CPU step at 256^2 takes minutes)
        checks = {}
        t0 = time.perf_counter()
        for preset in ("unet_gan", "fastddpm"):
            cfg = preset_cfg(preset)
            checks[preset] = family_step_check(preset, cfg, first_batch(cfg),
                                               dev, card, worst_2x=True)
        for preset in ("deepcnn", "progressive_unet", "fastddpm_simple"):
            cfg = preset_cfg(preset)
            kind = "window" if preset == "progressive_unet" else "triplet"
            b = first_batch(cfg, kind)[:SMALL_BATCH]
            small = F.avg_pool2d(b.permute(0, 3, 1, 2), HW // SMALL_HW
                                 ).permute(0, 2, 3, 1).contiguous()
            checks[preset] = family_step_check(
                preset, preset_cfg(preset, SMALL_HW, SMALL_BATCH), small,
                dev, card)
        walls["card vs CPU steps"] = time.perf_counter() - t0
        results["card_vs_cpu"] = checks

        loader = build_loader(store, "test", dataclasses.replace(
            preset_cfg("unet_gan").data, batch_size=BATCH), device=dev)
        requests = torch.cat([b[..., :2] for b in loader])[:TRAIN_REQUESTS]
        requests = requests.cpu().numpy()
        for preset in ("fastddpm", "unet_gan", "deepcnn", "progressive_unet",
                       "fastddpm_simple"):
            t_family = time.perf_counter()
            fam, fwalls = {}, {}
            models_dir = os.path.join(work, preset, "models")
            results_dir = os.path.join(work, preset, "results")
            common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                      "--results-dir", results_dir, "--features",
                      str(FEATURES), "--image-size", str(HW), "--device",
                      str(dev)]
            train = ["train", "--preset", preset, *common]
            t0 = time.perf_counter()
            trainer = cli.main([*train, "--epochs", "1"])
            fwalls["train 1 epoch"] = time.perf_counter() - t0
            timings, last = list(trainer.timings), trainer
            resumes = preset in ("fastddpm", "unet_gan")
            if resumes:
                del trainer, last
                t0 = time.perf_counter()
                last = cli.main([*train, "--epochs", "2", "--resume"])
                fwalls["train --resume to 2"] = time.perf_counter() - t0
                if last.start_epoch != 2:
                    raise AssertionError(f"{preset} resumed at "
                                         f"{last.start_epoch}")
                timings += last.timings
            else:
                del trainer
            with open(os.path.join(results_dir,
                                   f"{preset}_history.json")) as f:
                hist = json.load(f)
            if keep is not None and preset in ("fastddpm", "deepcnn",
                                               "progressive_unet"):
                shutil.copy(os.path.join(models_dir, f"{preset}_best.pt"),
                            keep)
            epochs = [1.0, 2.0] if resumes else [1.0]
            if hist["epoch"] != epochs or not all(np.isfinite(
                    hist["train_loss"] + hist["val_loss"])):
                raise AssertionError(f"{preset} history {hist['epoch']} "
                                     f"{hist['train_loss']} "
                                     f"{hist['val_loss']}")
            # one more step of the trained state: its device time and
            # its split by op kind
            kind = "window" if preset == "progressive_unet" else "triplet"
            xb = next(iter(build_loader(store, "train", preset_cfg(
                preset).data, kind=kind, device=dev)))
            g = last._generator(0, True, 0)
            fam["step_ms"] = cuda_ms(lambda: last._train(xb, g), reps=3,
                                     warmup=1)
            fam["step_split"] = profile_step(lambda: last._train(xb, g))
            del last
            tr = [t for t in timings if t["train"]]
            steps = sum(t["steps"] for t in tr)
            seconds = sum(t["seconds"] for t in tr)
            fam.update(train_loss=hist["train_loss"],
                       val_loss=hist["val_loss"], steps=steps,
                       seconds=seconds, steps_per_s=steps / seconds)
            split = fam["step_split"]
            print(f"{preset}: train losses {hist['train_loss']}, val losses "
                  f"{hist['val_loss']}; {steps} steps in {seconds:.3f} s = "
                  f"{steps / seconds:.3f} steps/s; one step "
                  f"{fam['step_ms']:.3f} ms on the card"
                  + ("" if split is None else
                     f" (device {split['total']:.3f} ms: convs "
                     f"{split['conv']:.3f}, BN/GN {split['bn']:.3f}, other "
                     f"{split['other']:.3f})") + f" ({card})")
            mcfg = preset_cfg(preset).model
            if preset != "fastddpm":
                t0 = time.perf_counter()
                _, counts = count_launches(lambda: cli.main([
                    "eval", "--model", preset, *common, "--batch-size",
                    str(BATCH)]))
                fwalls["eval"] = time.perf_counter() - t0
                add_counts(launches, counts)
                if counts["ssim"] <= 0:
                    raise AssertionError(f"K1 was not launched by the "
                                         f"trained {preset} eval")
                with open(os.path.join(results_dir,
                                       f"{preset}_test_metrics.json")) as f:
                    metrics = json.load(f)
                model = load_model(preset, models_dir, checkpoint="required",
                                   cfg=mcfg, device=dev)
                fam["eval"] = eval_against_plain(
                    preset, model, store, preset_cfg(preset).data, metrics)
                del model
            if preset in ("fastddpm", "unet_gan"):
                quant = "int8_deep" if preset == "fastddpm" else "int8_fused"
                bundle = os.path.join(work, preset, "bundle")
                t0 = time.perf_counter()
                cli.main(["export-serving", "--model", preset, *common,
                          "--quant", quant, "--batch-size", str(BATCH),
                          "--calib-batches", "2", "--out", bundle])
                fwalls["export-serving"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                n = DIFF_REQUESTS if preset == "fastddpm" else TRAIN_REQUESTS
                fam["serving"], counts = serve_trained(
                    preset, bundle, requests[:n], dev, models_dir, mcfg)
                fwalls["serve"] = time.perf_counter() - t0
                add_counts(launches, counts)
            fwalls["family"] = time.perf_counter() - t_family
            fam["wall_s"] = fwalls
            results[preset] = fam
            print(f"{preset} wall (s): " + ", ".join(
                f"{k} {v:.2f}" for k, v in fwalls.items()))
    walls["phase"] = time.perf_counter() - t_phase
    results["wall_s"], results["launches"] = walls, launches
    for kernel in ("ssim", "conv_int8", "upconv_int8", "groupnorm_silu"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{kernel} was not launched in phase 9")
    print(f"families phase launches {launches}")
    print("families wall (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items()))
    return launches, results


# phase 10: the six families trained in bf16 compute
BF16_FAMILIES = ("unet_combined", "unet_gan", "deepcnn", "progressive_unet",
                 "fastddpm", "fastddpm_simple")
PEAK_BF16_OPS = 989e12  # H100 SXM dense bf16 (data sheet, 700 W)
# a bf16 step against the same step in float64: losses within
# BF16_LOSS_RTOL (bf16's unit roundoff is 3.9e-3); the gradients of the
# weights and norm parameters, as one vector, within BF16_GRAD_BUDGET
# rel-L2; the card's worst tensor at most 2x the CPU bf16 step's worst
BF16_LOSS_RTOL, BF16_GRAD_BUDGET = 2e-2, 0.5
# a bf16 served forward (quant 'none' bundle) against the folded float32
# forward; engine_from_model's 'none' (float32 over bf16-rounded weights)
BF16_SERVE_RTOL, BF16_WEIGHTS_RTOL = 5e-2, 1e-2
# kernel A launches of one full-width forward: unet_int8_apply (9 blocks x
# 2 convs; enc1/Conv_0 on dp4a) and the pre-r3 fallback ('dual': the 4
# encoder blocks emit Conv_1 twice)
INT8_APPLY_A = {"tc": 17, "dp4a": 1}
LEGACY_A = {"tc": 21, "dp4a": 1}


def step_flops(fn) -> float:
    """The conv and matmul FLOPs of one call of ``fn`` (forward and
    backward), counted by ``torch.utils.flop_counter`` from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def weights_and_norms(module):
    """Parameter names of ``module`` except the conv biases right before a
    training-mode BatchNorm (zero in exact arithmetic, noise on every
    side)."""
    return [n for n, _ in module.named_parameters()
            if not (n.endswith(".bias") and n.rpartition(".")[0].endswith(
                (".conv.0", ".conv.3")))]


def bf16_step_check(preset, cfg, batch, dev, card):
    """One bf16 train step of ``preset`` on the card and on the CPU from
    the same init_model weights and batch, each held against the same step
    in float64 on the CPU: losses within BF16_LOSS_RTOL, the weights' and
    norm parameters' gradients as one vector within BF16_GRAD_BUDGET, and
    the card's worst tensor (``grad_errors``) at most 2x the CPU bf16
    step's worst.  A diffusion step takes fixed draws."""
    import dataclasses

    bf16 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 compute_dtype="bfloat16"))
    sides = {"card": (dev, bf16, torch.float32),
             "CPU": (torch.device("cpu"), bf16, torch.float32),
             "f64": (torch.device("cpu"), cfg, torch.float64)}
    g = torch.Generator().manual_seed(1)
    b = batch.shape[0]
    t_idx = torch.randint(0, cfg.model.num_inference_steps, (b,),
                          generator=g)
    eps = torch.randn(batch[..., 2:3].shape, generator=g)
    runs = {}
    for side, (device, side_cfg, dtype) in sides.items():
        tr, states = make_trainer(preset, side_cfg, device, dtype)
        x = batch.to(device, dtype)
        if cfg.loss.kind == "gan":
            metrics = tr.train_step(tr.g_state, tr.d_state, x)[-1]
        elif cfg.loss.kind == "diffusion":
            metrics = tr.train_step.train_on(
                tr.state, x, t_idx.to(device), eps.to(device, dtype))[1]
        else:
            metrics = tr.train_step(tr.state, x)[1]
        runs[side] = ({k: float(v) for k, v in metrics.items()},
                      {n: st.module for n, st in states.items()})
    ref_metrics, ref_modules = runs.pop("f64")
    out = {}
    for side, (metrics, modules) in runs.items():
        loss_rel = max(abs(metrics[k] - ref_metrics[k]) / abs(ref_metrics[k])
                       for k in ref_metrics if k in ("loss", "g", "d"))
        errs, got, want = {}, [], []
        for name, module in modules.items():
            ref = ref_modules[name]
            errs.update({f"{name}:{k}": v for k, v in grad_errors(
                module, ref).items()})
            grads = dict(module.named_parameters())
            refs = dict(ref.named_parameters())
            for k in weights_and_norms(module):
                got.append(grads[k].grad.detach().double().cpu().ravel())
                want.append(refs[k].grad.detach().double().ravel())
        got, want = torch.cat(got), torch.cat(want)
        worst = max(errs, key=errs.get)
        out[side] = {"loss_rel": loss_rel,
                     "grad_rel_l2": float((got - want).norm() / want.norm()),
                     "worst": errs[worst], "worst_tensor": worst}
    on_card, on_cpu = out["card"], out["CPU"]
    print(f"{preset} bf16 train step, card and CPU vs float64 CPU (batch "
          f"{tuple(batch.shape)}; {card}): loss rel {on_card['loss_rel']:.3g}"
          f" card, {on_cpu['loss_rel']:.3g} CPU; gradients rel-L2 "
          f"{on_card['grad_rel_l2']:.3g} card, {on_cpu['grad_rel_l2']:.3g} "
          f"CPU; worst tensor {on_card['worst']:.3g} card "
          f"({on_card['worst_tensor']}), {on_cpu['worst']:.3g} CPU "
          f"({on_cpu['worst_tensor']})")
    for side, r in out.items():
        if not r["loss_rel"] <= BF16_LOSS_RTOL:
            raise AssertionError(f"{preset} bf16 step loss {side} vs float64 "
                                 f"rel {r['loss_rel']}")
        if not r["grad_rel_l2"] <= BF16_GRAD_BUDGET:
            raise AssertionError(f"{preset} bf16 gradients {side} vs float64 "
                                 f"rel-L2 {r['grad_rel_l2']}")
    if not on_card["worst"] <= 2 * on_cpu["worst"]:
        raise AssertionError(f"{preset} card's worst bf16 gradient "
                             f"{on_card['worst']} over 2x the CPU's "
                             f"{on_cpu['worst']}")
    return out


def bf16_step_time(preset, cfg, store, dev, card):
    """One full-size bf16 train step of ``preset`` on the card: its device
    time (CUDA events), the host clock's time a step over 5 steps, its
    conv/matmul FLOPs and their bound at the bf16 peak, and its
    ``torch.profiler`` split."""
    import dataclasses

    from mrisr_tpu_torch.data.pipeline import build_loader

    bf16 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 compute_dtype="bfloat16"))
    tr, _ = make_trainer(preset, bf16, dev)
    kind = "window" if preset == "progressive_unet" else "triplet"
    xb = next(iter(build_loader(store, "train", cfg.data, kind=kind,
                                device=dev)))
    g = tr._generator(0, True, 0)
    out = {"step_ms": cuda_ms(lambda: tr._train(xb, g), reps=3, warmup=1)}
    # the host's time a step over 5 queued steps: where it matches the
    # device time, the host's launches set the pace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tr._train(xb, g)
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out["flops"] = step_flops(lambda: tr._train(xb, g))
    out["bound_ms"] = out["flops"] / PEAK_BF16_OPS * 1e3
    out["split"] = profile_step(lambda: tr._train(xb, g))
    split = out["split"]
    print(f"{preset} bf16 step {out['step_ms']:.3f} ms on the card "
          f"({out['host_ms']:.3f} ms a step on the host clock over 5), "
          f"{out['flops'] / 1e12:.3f} TFLOP of convs and matmuls, bound "
          f"{out['bound_ms']:.3f} ms at 989 TFLOP/s"
          + ("" if split is None else
             f" (device {split['total']:.3f} ms: convs {split['conv']:.3f}, "
             f"BN/GN {split['bn']:.3f}, other {split['other']:.3f})")
          + f" ({card})")
    return out


def bf16_phase(dev, card: str):
    """bf16 training of the six families and the remaining pair serving
    paths (see the module docstring, item 10).  Returns (launches,
    results)."""
    import dataclasses

    import torch.nn.functional as F

    from mrisr_tpu_torch import cli, fp32_reference
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.ops.conv_int8 import conv_path
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, Int8UNet, calibrate_unet, engine_from_bundle,
        engine_from_model, load_bundle, quantize_unet)

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()

    def preset_cfg(preset, hw=HW, batch=TRAIN_BATCH):
        base = PRESETS[preset]
        return base.replace(
            data=dataclasses.replace(base.data, image_size=(hw, hw),
                                     batch_size=batch, augment=False),
            model=dataclasses.replace(base.model, base_features=FEATURES))

    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(FAMILY_PATIENTS),
                  "--slices", str(FAMILY_SLICES), "--size", str(HW)])
        store = VolumeStore.open(store_dir)
        walls["synth"] = time.perf_counter() - t0

        # --- 1. each family's full-size bf16 step: time, bound, split (first,
        # on a host that has run no CPU step yet)
        t0 = time.perf_counter()
        results["steps"] = {p: bf16_step_time(p, preset_cfg(p), store, dev,
                                              card) for p in BF16_FAMILIES}
        walls["bf16 step times"] = time.perf_counter() - t0

        # --- 2. one bf16 step of each family, card and CPU vs float64, at
        # SMALL_HW and SMALL_BATCH
        t0 = time.perf_counter()
        checks = {}
        for preset in BF16_FAMILIES:
            kind = "window" if preset == "progressive_unet" else "triplet"
            b = next(iter(build_loader(store, "train", preset_cfg(
                preset).data, kind=kind, device="cpu")))[:SMALL_BATCH]
            small = F.avg_pool2d(b.permute(0, 3, 1, 2), HW // SMALL_HW
                                 ).permute(0, 2, 3, 1).contiguous()
            checks[preset] = bf16_step_check(
                preset, preset_cfg(preset, SMALL_HW, SMALL_BATCH), small,
                dev, card)
        walls["card vs CPU bf16 steps"] = time.perf_counter() - t0
        results["card_vs_cpu"] = checks

        # --- 3. cli train --bf16: unet_combined 1 epoch then --resume to
        # 2, fastddpm 1 epoch
        for preset, epochs in (("unet_combined", (1, 2)), ("fastddpm", (1,))):
            models_dir = os.path.join(work, preset, "models")
            results_dir = os.path.join(work, preset, "results")
            common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                      "--results-dir", results_dir, "--features",
                      str(FEATURES), "--image-size", str(HW), "--device",
                      str(dev), "--bf16"]
            timings = []
            for i, n in enumerate(epochs):
                t0 = time.perf_counter()
                tr = cli.main(["train", "--preset", preset, *common,
                               "--epochs", str(n), *(["--resume"] if i
                                                     else [])])
                walls[f"cli train --bf16 {preset} to {n}"] = (
                    time.perf_counter() - t0)
                if tr.config.train.compute_dtype != "bfloat16":
                    raise AssertionError(f"{preset} trained in "
                                         f"{tr.config.train.compute_dtype}")
                if i and tr.start_epoch != n:
                    raise AssertionError(f"{preset} resumed at "
                                         f"{tr.start_epoch}")
                timings += [t for t in tr.timings if t["train"]]
                del tr
            with open(os.path.join(results_dir,
                                   f"{preset}_history.json")) as f:
                hist = json.load(f)
            if hist["epoch"] != [float(e) for e in range(1, epochs[-1] + 1)] \
                    or not all(np.isfinite(hist["train_loss"]
                                           + hist["val_loss"])):
                raise AssertionError(f"{preset} bf16 history {hist}")
            steps = sum(t["steps"] for t in timings)
            seconds = sum(t["seconds"] for t in timings)
            results[f"cli_{preset}"] = {
                "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
                "steps": steps, "seconds": seconds,
                "steps_per_s": steps / seconds}
            print(f"cli train --bf16 {preset}: train losses "
                  f"{hist['train_loss']}, val {hist['val_loss']}; {steps} "
                  f"steps in {seconds:.3f} s = {steps / seconds:.3f} steps/s "
                  f"({card})")

        # --- 4. the bf16-trained unet_combined: eval through K1, then
        # served as the pair bundles, by engine_from_model and through the
        # pre-r3 fallback
        mcfg = preset_cfg("unet_combined").model
        models_dir = os.path.join(work, "unet_combined", "models")
        common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                  "--results-dir", os.path.join(work, "unet_combined",
                                                "results"),
                  "--features", str(FEATURES), "--image-size", str(HW),
                  "--device", str(dev)]
        t0 = time.perf_counter()
        _, counts = count_launches(lambda: cli.main([
            "eval", "--model", "unet_combined", *common, "--batch-size",
            str(BATCH), "--bf16"]))
        walls["cli eval"] = time.perf_counter() - t0
        add_counts(launches, counts)
        if counts["ssim"] <= 0:
            raise AssertionError("K1 was not launched by the bf16-trained "
                                 "eval")
        with open(os.path.join(work, "unet_combined", "results",
                               "unet_combined_test_metrics.json")) as f:
            metrics = json.load(f)
        model = load_model("unet_combined", models_dir, checkpoint="required",
                           cfg=mcfg, device=dev)
        results["eval"] = eval_against_plain(
            "unet_combined (bf16)", model, store,
            preset_cfg("unet_combined").data, metrics)
        del model

        loader = build_loader(store, "test", dataclasses.replace(
            preset_cfg("unet_combined").data, batch_size=BATCH), device=dev)
        requests = torch.cat([b[..., :2] for b in loader])[:TRAIN_REQUESTS]
        requests = requests.cpu().numpy()
        x = torch.from_numpy(requests).to(dev)
        folded = load_model("unet_combined", models_dir,
                            checkpoint="required", cfg=mcfg, fold_bn=True,
                            device=dev)
        with fp32_reference():
            y_float = np.concatenate([folded.predict_nhwc(x[i:i + BATCH])
                                      .cpu().numpy()
                                      for i in range(0, len(x), BATCH)])
        val = build_loader(store, "val", dataclasses.replace(
            preset_cfg("unet_combined").data, batch_size=BATCH), device=dev)
        calib = [b[..., :2] for b, _ in zip(val, range(2))]

        def serve(make_engine, what, bound, plain_fn=None, a_paths=None,
                  b_per_forward=0):
            with make_engine() as eng:
                eng.predict(requests[0])
                eng.reset_stats()
                served, counts = count_launches(lambda: np.stack([
                    f.result(timeout=600) for f in [eng.submit(r)
                                                    for r in requests]]))
                batches = eng.stats.batches
            add_counts(launches, counts)
            rel = rel_l2(served, y_float)
            row = {"rel_l2_float": rel, "batches": batches, "launches": counts}
            if plain_fn is not None:
                y_plain = np.concatenate([plain_fn(x[i:i + BATCH]).cpu().numpy()
                                          for i in range(0, len(x), BATCH)])
                row["rel_l2_plain"] = rel_l2(served, y_plain)
            print(f"bf16-trained unet_combined {what}: vs the folded float32 "
                  f"forward rel-L2 {rel:.6f} (bound {bound})"
                  + ("" if plain_fn is None else
                     f"; vs plain versions {row['rel_l2_plain']:.6f} (must "
                     f"be 0)") + f"; launches {counts}")
            if served.shape != (len(requests), HW, HW, 1) or not np.isfinite(
                    served).all():
                raise AssertionError(f"{what} output {served.shape}")
            if not rel < bound:
                raise AssertionError(f"{what} vs float rel-L2 {rel}")
            if plain_fn is not None and row["rel_l2_plain"] != 0.0:
                raise AssertionError(f"{what} vs plain {row['rel_l2_plain']}")
            if a_paths is not None:
                check_paths(counts, {"conv_int8": a_paths}, batches, what)
            if counts["upconv_int8"] != b_per_forward * batches:
                raise AssertionError(f"{what}: kernel B launched "
                                     f"{counts['upconv_int8']} times")
            return row

        serving = {}
        t0 = time.perf_counter()
        for quant in ("none", "int8"):
            bundle = os.path.join(work, f"bundle_{quant}")
            cli.main(["export-serving", "--model", "unet_combined", *common,
                      "--quant", quant, "--batch-size", str(BATCH),
                      "--calib-batches", "2", "--out", bundle, "--bf16"])
            serving[f"bundle {quant}"] = serve(
                lambda: engine_from_bundle(bundle, batch_size=BATCH,
                                           device=dev),
                f"bundle quant={quant!r}",
                BF16_SERVE_RTOL if quant == "none" else 0.15,
                plain_fn=(Int8UNet(load_bundle(bundle)[0], device=dev,
                                   plain=True) if quant == "int8" else None),
                a_paths=INT8_APPLY_A if quant == "int8" else None)
        walls["export + serve bundles"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for quant, bound, a_paths, b_n in (
                ("none", BF16_WEIGHTS_RTOL, None, 0),
                ("int8", 0.15, INT8_APPLY_A, 0),
                ("int8_fused", 0.15, path_counts(conv_sites(), lambda st:
                                                 conv_path(st[2], st[3],
                                                           st[4])), 4)):
            serving[f"engine_from_model {quant}"] = serve(
                lambda: engine_from_model(
                    "unet_combined", models_dir, quant=quant,
                    batch_size=BATCH, image_size=(HW, HW),
                    calibration_batches=calib, cfg=mcfg, device=dev),
                f"engine_from_model quant={quant!r}", bound,
                a_paths=a_paths, b_per_forward=b_n)
        walls["engine_from_model"] = time.perf_counter() - t0
        # the same calibration without its upconv/final entries: a pre-r3
        # table, served by the int8_fused fallback
        t0 = time.perf_counter()
        ranges = calibrate_unet(folded.module, calib)
        legacy = quantize_unet(folded.module, {
            k: v for k, v in ranges.items()
            if not k.startswith(("upconv", "final"))})
        fwd = Int8FusedUNet(legacy, device=dev)

        class _Legacy:
            """An engine-shaped runner of the fallback over the requests."""

            def __enter__(self):
                from mrisr_tpu_torch.serve import InferenceEngine

                self.eng = InferenceEngine(fwd, batch_size=BATCH,
                                           input_shape=(HW, HW, 2),
                                           device=dev)
                return self.eng

            def __exit__(self, *exc):
                self.eng.close()

        serving["legacy int8_fused"] = serve(
            _Legacy, "pre-r3 tables (int8_fused fallback)", 0.15,
            plain_fn=Int8FusedUNet(legacy, device=dev, plain=True),
            a_paths=LEGACY_A)
        walls["legacy fallback"] = time.perf_counter() - t0
        results["serving"] = serving
    walls["phase"] = time.perf_counter() - t_phase
    results["wall_s"], results["launches"] = walls, launches
    for kernel in ("ssim", "conv_int8", "upconv_int8"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{kernel} was not launched in phase 10")
    print(f"bf16 phase launches {launches}")
    print("bf16 wall (s): " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in walls.items()))
    return launches, results


# phase 11: serving distillation.  The unet_distilled preset (half width,
# batch 32, bf16 compute, augment) against phase 8's trained unet_combined
# (the int8_fused teacher), on a phase 8-sized store; phase 9's fastddpm
# step-distilled 10 -> 5 -> 3; both students served, also over HTTP
DISTILL_BATCH = 32
STEP_EVAL_BATCHES = 1  # distill-steps --max-eval-batches
HTTP_REQUESTS = 3      # sequential POSTs per served bundle
EMA_ATOL = 1e-5        # the EMA after one step, card vs float64
UNET_A, UNET_B = 19, 4  # launches of one int8_fused UNet forward


def expect_launches(counts, per_forward, forwards, what):
    """``counts[kernel] == n * forwards`` for each ``kernel: n``."""
    for name, n in per_forward.items():
        if counts[name] != n * forwards:
            raise AssertionError(f"{what} {name}: {counts[name]} launches "
                                 f"for {forwards} forwards, want {n} each")


def steady_state(bundle, requests, dev):
    """One bundle's engine at its steady state (batch 8, STEADY_BATCHES
    full batches), one batch's device ms and host ms to enqueue."""
    from mrisr_tpu_torch.serve import engine_from_bundle

    with engine_from_bundle(bundle, batch_size=BATCH, device=dev) as eng:
        eng.predict(requests[0])
        eng.reset_stats()
        burst = [eng.submit(requests[i % len(requests)])
                 for i in range(STEADY_BATCHES * BATCH)]
        for fut in burst:
            fut.result(timeout=600)
        st = eng.stats
        x8 = torch.from_numpy(requests[np.arange(BATCH) % len(requests)]).to(
            dev)
        ms = cuda_ms(lambda: eng._apply(x8), reps=3, warmup=1)
        host = host_us(lambda: eng._apply(x8), calls=3) / 1e3
    return {"slices_per_sec": st.slices_per_sec, "requests": st.requests,
            "batch_ms": ms, "host_ms": host}


def http_check(bundle, requests, dev, what):
    """Serve ``bundle`` over HTTP on 127.0.0.1 (port 0, a background
    thread): sequential POSTs, each equal to the bundle's forward of a
    batch of that request (the engine wrap-pads a lone request), /healthz,
    /stats counting them, a bad body answered 400.  Returns (results,
    launches of the served requests)."""
    import io
    import urllib.error
    import urllib.request

    from mrisr_tpu_torch.serve import load_bundle, make_bundle_apply
    from mrisr_tpu_torch.serve.http import serve_bundle

    apply = make_bundle_apply(*load_bundle(bundle), dev)
    with serve_bundle(bundle, port=0, batch_size=BATCH,
                      device=dev).start_background() as server:
        url = f"http://{server.host}:{server.port}"

        def post(body):
            req = urllib.request.Request(url + "/predict", data=body)
            with urllib.request.urlopen(req, timeout=600) as resp:
                return np.load(io.BytesIO(resp.read()))

        def body_of(x):
            buf = io.BytesIO()
            np.save(buf, x)
            return buf.getvalue()

        answers, counts = count_launches(lambda: [
            post(body_of(requests[i])) for i in range(HTTP_REQUESTS)])
        for i, y in enumerate(answers):
            x = torch.from_numpy(np.repeat(requests[i][None], BATCH, 0)).to(
                dev)
            want = apply(x)[0].cpu().numpy()
            if y.shape != (HW, HW, 1) or not np.array_equal(y, want):
                raise AssertionError(f"{what} HTTP answer {i} differs from "
                                     f"the engine's forward")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = resp.read()
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        try:
            post(b"not an npy")
            bad = 200
        except urllib.error.HTTPError as e:
            bad = e.code
    print(f"{what} over HTTP: {HTTP_REQUESTS} answers equal to the engine's "
          f"forward; /healthz {health!r}; /stats {stats}; a bad body {bad}")
    if health != b"ok" or stats["requests"] != HTTP_REQUESTS or bad != 400:
        raise AssertionError(f"{what} HTTP: health {health!r}, stats "
                             f"{stats}, bad body {bad}")
    return {"stats": stats, "bad_status": bad}, counts


def distill_phase(dev, card: str, teachers: str):
    """Serving distillation at full width (see the module docstring, item
    11): ``teachers`` holds phase 8's unet_combined_best.pt and phase 9's
    fastddpm_best.pt.  Returns (launches, results)."""
    import copy
    import dataclasses
    import itertools

    import torch.nn.functional as F

    from mrisr_tpu_torch import cli, fp32_reference
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.torch_ckpt import (
        load_checkpoint_file, port_state_dict)
    from mrisr_tpu_torch.config import PRESETS, TrainConfig
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.ops.conv_int8 import conv_path
    from mrisr_tpu_torch.ops.upconv import upconv_path
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, calibrate_unet, load_bundle, make_bundle_apply,
        quantize_unet)
    from mrisr_tpu_torch.serve.distill import (
        DistillationTrainer, make_teacher_fn)
    from mrisr_tpu_torch.serve.distill_diffusion import (
        frozen_bf16_teacher, make_stepdistill_steps)
    from mrisr_tpu_torch.serve.engine import bf16_rounded_copy
    from mrisr_tpu_torch.train.state import create_train_state

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()
    sf = FEATURES // 2  # the unet_distilled preset's 32 at full width
    teacher_mcfg = dataclasses.replace(PRESETS["unet_combined"].model,
                                       base_features=FEATURES)
    base = PRESETS["unet_distilled"]
    student = base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW)),
        model=dataclasses.replace(base.model, base_features=sf))
    fast_mcfg = dataclasses.replace(PRESETS["fastddpm"].model,
                                    base_features=FEATURES)
    unet_paths = {
        "conv_int8": path_counts(conv_sites(FEATURES), lambda st: conv_path(
            st[2], st[3], st[4])),
        "upconv_int8": path_counts(upconv_sites(FEATURES), lambda st:
                                   upconv_path(st[2], st[3]))}

    with tempfile.TemporaryDirectory() as work:
        models_dir = os.path.join(work, "models")
        results_dir = os.path.join(work, "results")
        store_dir = os.path.join(work, "store")
        os.makedirs(models_dir)
        for f in ("unet_combined_best.pt", "fastddpm_best.pt"):
            shutil.copy(os.path.join(teachers, f), models_dir)
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(TRAIN_PATIENTS),
                  "--slices", str(TRAIN_SLICES), "--size", str(HW)])
        store = VolumeStore.open(store_dir)
        walls["synth"] = time.perf_counter() - t0

        # --- 1. one float32 distill step (float teacher, pruned init, EMA
        # and the SSIM term) on the card and on the CPU at SMALL_HW, batch
        # SMALL_BATCH, each held against the same step in float64
        t0 = time.perf_counter()
        small = student.replace(
            data=dataclasses.replace(student.data, augment=False,
                                     image_size=(SMALL_HW, SMALL_HW),
                                     batch_size=SMALL_BATCH),
            loss=dataclasses.replace(student.loss, distill_ema=0.999,
                                     distill_lambda_ssim=0.1),
            train=dataclasses.replace(student.train,
                                      compute_dtype="float32"))
        b = next(iter(build_loader(store, "train", dataclasses.replace(
            student.data, augment=False), device="cpu")))[:SMALL_BATCH]
        batch = F.avg_pool2d(b.permute(0, 3, 1, 2), HW // SMALL_HW).permute(
            0, 2, 3, 1).contiguous()
        folded = load_model("unet_combined", models_dir,
                            checkpoint="required", cfg=teacher_mcfg,
                            fold_bn=True, device="cpu").module
        teacher64 = bf16_rounded_copy(folded).double()

        def ref_teacher(x):
            with torch.no_grad():
                return teacher64(x.double())

        def trainer(device, teacher_fn):
            return DistillationTrainer(
                small, teacher_fn=teacher_fn, teacher_name="unet_combined",
                teacher_models_dir=models_dir, teacher_cfg=teacher_mcfg,
                init_from_teacher=True, device=device)

        sides = {s: trainer(d, make_teacher_fn(
            "unet_combined", models_dir, cfg=teacher_mcfg, device=d))
            for s, d in (("card", dev), ("CPU", "cpu"))}
        ref = trainer("cpu", ref_teacher)
        ref.state.module.double()
        ref.state.seed_ema()
        for (k, a), b2 in zip(sides["card"].state.module.state_dict().items(),
                              sides["CPU"].state.module.state_dict().values()):
            if not torch.equal(a.cpu(), b2):
                raise AssertionError(f"pruned init differs on the card: {k}")
        metrics = {"card": sides["card"].train_step(
            sides["card"].state, batch.to(dev))[1],
            "CPU": sides["CPU"].train_step(sides["CPU"].state, batch)[1]}
        m_ref = ref.train_step(ref.state, batch.double())[1]
        ref_loss = float(m_ref["loss"])
        loss_rel = {s: abs(float(m["loss"]) - ref_loss) / abs(ref_loss)
                    for s, m in metrics.items()}
        errs = {s: grad_errors(t.state.module, ref.state.module)
                for s, t in sides.items()}
        stats_err = {s: max(
            float((a.cpu().double() - b2).abs().max()) for (k, a), b2 in zip(
                t.state.module.named_buffers(), ref.state.module.buffers())
            if "running" in k) for s, t in sides.items()}
        ema_err = {s: max(float((t.state.ema_params[n].cpu().double()
                                 - e).abs().max())
                          for n, e in ref.state.ema_params.items())
                   for s, t in sides.items()}
        bound = {n: max(GRAD_RTOL, GRAD_NOISE_FACTOR * e)
                 for n, e in errs["CPU"].items()}
        over = [n for n, e in errs["card"].items() if not e <= bound[n]]
        print(f"distill step, float32 card and CPU vs float64 CPU (student "
              f"features {sf}, pruned from the features-{FEATURES} teacher, "
              f"{SMALL_HW}x{SMALL_HW}, batch {SMALL_BATCH}, EMA 0.999, SSIM "
              f"0.1): loss {ref_loss:.9f}, rel {loss_rel['card']:.3g} card, "
              f"{loss_rel['CPU']:.3g} CPU (bound 1e-4); BN stats "
              f"{stats_err['card']:.3g} / {stats_err['CPU']:.3g} (bound "
              f"1e-4); EMA {ema_err['card']:.3g} / {ema_err['CPU']:.3g} "
              f"(bound {EMA_ATOL:g}); gradients past rel-L2 {GRAD_RTOL:g}: "
              f"{sum(e > GRAD_RTOL for e in errs['card'].values())} card, "
              f"{sum(e > GRAD_RTOL for e in errs['CPU'].values())} CPU of "
              f"{len(bound)}; worst {max(errs['card'].values()):.3g} card, "
              f"{max(errs['CPU'].values()):.3g} CPU")
        if not loss_rel["card"] <= 1e-4:
            raise AssertionError(f"distill step loss rel {loss_rel['card']}")
        if not stats_err["card"] <= 1e-4:
            raise AssertionError(f"distill BN stats {stats_err['card']}")
        if not ema_err["card"] <= EMA_ATOL:
            raise AssertionError(f"distill EMA {ema_err['card']}")
        if over:
            raise AssertionError(f"distill gradients past their bound: "
                                 f"{over}")
        results["card_vs_cpu"] = {"loss_rel_f64": loss_rel,
                                  "bn_stats_err_f64": stats_err,
                                  "ema_err_f64": ema_err,
                                  "grad_rel_l2_f64": errs}
        del sides, ref, teacher64
        walls["card vs CPU distill step"] = time.perf_counter() - t0

        # --- 2. the int8_fused teacher at the distill batch (32) on the
        # card against its plain versions on the same tables
        t0 = time.perf_counter()
        full_data = dataclasses.replace(student.data,
                                        batch_size=DISTILL_BATCH)
        val = build_loader(store, "val", full_data, device=dev)
        calib = [vb[..., :2] for vb in itertools.islice(iter(val), 4)]
        folded_card = load_model("unet_combined", models_dir,
                                 checkpoint="required", cfg=teacher_mcfg,
                                 fold_bn=True, device=dev).module
        q = quantize_unet(folded_card, calibrate_unet(folded_card, calib))
        fwd = Int8FusedUNet(q, device=dev)
        xb = next(iter(build_loader(store, "train", full_data,
                                    device=dev)))
        y_k, counts = count_launches(lambda: fwd(xb[..., :2]))
        torch.cuda.synchronize()
        y_p = Int8FusedUNet(q, device=dev, plain=True)(xb[..., :2])
        if not (torch.equal(y_k, y_p) and torch.equal(fwd(xb[..., :2]), y_k)):
            raise AssertionError(
                f"the int8_fused teacher at batch {DISTILL_BATCH} differs "
                f"from its plain versions: max "
                f"{float((y_k - y_p).abs().max())}")
        expect_launches(counts, {"conv_int8": UNET_A, "upconv_int8": UNET_B},
                        1, "teacher")
        check_paths(counts, unet_paths, 1, "teacher")
        teacher_ms = cuda_ms(lambda: fwd(xb[..., :2]), reps=5)
        print(f"int8_fused teacher at batch {DISTILL_BATCH}: equal to its "
              f"plain versions, {teacher_ms:.3f} ms on the card ({card})")
        results["teacher"] = {"batch": DISTILL_BATCH, "ms": teacher_ms}
        del folded_card, fwd
        walls["teacher vs plain"] = time.perf_counter() - t0

        # --- 3. cli distill: 1 epoch, the restore checked, --resume to 2
        common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                  "--results-dir", results_dir, "--image-size", str(HW),
                  "--device", str(dev)]
        distill = ["distill", "--teacher", "unet_combined",
                   "--teacher-features", str(FEATURES), "--teacher-quant",
                   "int8_fused", "--init-from-teacher", "--ema", "0.999",
                   "--distill-lambda-ssim", "0.1", "--features", str(sf),
                   "--batch-size", str(DISTILL_BATCH), *common]
        timings = []
        for n in (1, 2):
            t0 = time.perf_counter()
            tr, counts = count_launches(lambda: cli.main(
                [*distill, "--epochs", str(n), *(["--resume"] if n > 1
                                                 else [])]))
            walls[f"cli distill to {n}"] = time.perf_counter() - t0
            add_counts(launches, counts)
            run = tr.timings
            forwards = sum(t["steps"] for t in run)
            expect_launches(counts, {"conv_int8": UNET_A,
                                     "upconv_int8": UNET_B}, forwards,
                            f"cli distill to {n} (teacher)")
            check_paths(counts, unet_paths, forwards, f"cli distill to {n}")
            if tr.config.train.compute_dtype != "bfloat16" or \
                    tr.config.data.batch_size != DISTILL_BATCH:
                raise AssertionError(f"distill config {tr.config.train}")
            timings += [t for t in run if t["train"]]
            if n == 1:
                # a trainer resumed from epoch 1 holds its live weights and
                # its average, as the checkpoint stores them
                ck = load_checkpoint_file(os.path.join(
                    models_dir, "unet_distilled_epoch_1.pt"))
                live = port_state_dict(ck["live_params"])
                ema = port_state_dict(ck["model_state_dict"])
                probe = DistillationTrainer(tr.config,
                                            teacher_fn=lambda x: x[..., :1],
                                            device=dev)
                if not probe.try_resume() or probe.start_epoch != 2:
                    raise AssertionError("distill did not resume at 2")
                moved = [k for k, p in probe.state.module.named_parameters()
                         if not (torch.equal(p.detach().cpu(), live[k])
                                 and torch.equal(probe.state.ema_params[k]
                                                 .cpu(), ema[k]))]
                if moved:
                    raise AssertionError(f"restored EMA/live weights "
                                         f"differ: {moved[:3]}")
                if all(torch.equal(live[k], ema[k]) for k in live):
                    raise AssertionError("the checkpoint's average equals "
                                         "its live weights")
                del probe
            else:
                start = tr.start_epoch
            last = tr
        with open(os.path.join(results_dir,
                               "unet_distilled_history.json")) as f:
            hist = json.load(f)
        if start != 2 or hist["epoch"] != [1.0, 2.0] or not all(np.isfinite(
                hist["train_loss"] + hist["val_loss"]
                + hist["train_teacher_mse"] + hist["train_ssim_loss"])):
            raise AssertionError(f"distill history {hist['epoch']} "
                                 f"{hist['train_loss']} (resumed at {start})")
        steps = sum(t["steps"] for t in timings)
        seconds = sum(t["seconds"] for t in timings)
        xs = next(iter(build_loader(store, "train", full_data, device=dev)))
        step_ms = cuda_ms(lambda: last._train(xs, None), reps=3, warmup=1)
        step_host_ms = host_us(lambda: last._train(xs, None), calls=3) / 1e3
        split = profile_step(lambda: last._train(xs, None))
        results["distill"] = {
            "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
            "teacher_mse": hist["train_teacher_mse"], "steps": steps,
            "seconds": seconds, "steps_per_s": steps / seconds,
            "step_ms": step_ms, "step_host_ms": step_host_ms,
            "step_split": split}
        print(f"cli distill (unet_distilled, features {sf}, batch "
              f"{DISTILL_BATCH}, bf16, int8_fused teacher, EMA 0.999): train "
              f"losses {hist['train_loss']}, val {hist['val_loss']}; "
              f"{steps} steps in {seconds:.3f} s = {steps / seconds:.3f} "
              f"steps/s; one step {step_ms:.3f} ms on the card, "
              f"{step_host_ms:.3f} ms of host time"
              + ("" if split is None else
                 f" (device {split['total']:.3f} ms: convs "
                 f"{split['conv']:.3f}, BN/GN {split['bn']:.3f}, other "
                 f"{split['other']:.3f})") + f" ({card})")
        del last, tr

        # --- 4. the student through K1 (eval) and A, B (its bundle)
        scommon = [*common, "--features", str(sf)]
        t0 = time.perf_counter()
        _, counts = count_launches(lambda: cli.main([
            "eval", "--model", "unet_distilled", *scommon, "--batch-size",
            str(BATCH)]))
        walls["cli eval student"] = time.perf_counter() - t0
        add_counts(launches, counts)
        if counts["ssim"] <= 0:
            raise AssertionError("K1 was not launched by the student's eval")
        with open(os.path.join(results_dir,
                               "unet_distilled_test_metrics.json")) as f:
            metrics = json.load(f)
        model = load_model("unet_distilled", models_dir,
                           checkpoint="required", cfg=student.model,
                           device=dev)
        results["eval"] = eval_against_plain("unet_distilled", model, store,
                                             student.data, metrics)
        del model
        loader = build_loader(store, "test", dataclasses.replace(
            student.data, batch_size=BATCH, augment=False), device=dev)
        requests = torch.cat([tb[..., :2] for tb in loader]).cpu().numpy()
        bundles = {}
        t0 = time.perf_counter()
        for name, feats in (("unet_distilled", sf),
                            ("unet_combined", FEATURES)):
            bundles[name] = os.path.join(work, f"bundle_{name}")
            cli.main(["export-serving", "--model", name, *common,
                      "--features", str(feats), "--quant", "int8_fused",
                      "--batch-size", str(BATCH), "--calib-batches", "2",
                      "--out", bundles[name]])
        walls["export pair bundles"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results["serving"], counts = serve_trained(
            "unet_distilled", bundles["unet_distilled"],
            requests[:TRAIN_REQUESTS], dev, models_dir, student.model,
            features=sf)
        add_counts(launches, counts)
        walls["serve student"] = time.perf_counter() - t0
        # the student's engine beside the teacher's, in turns
        t0 = time.perf_counter()
        turns = [(n, steady_state(bundles[n], requests, dev)) for n in (
            "unet_distilled", "unet_combined", "unet_combined",
            "unet_distilled")]
        walls["steady state"] = time.perf_counter() - t0
        results["steady"] = turns
        for n, st in turns:
            print(f"{n} int8_fused engine: {st['slices_per_sec']:.2f} "
                  f"slices/s ({st['requests']} requests, batch {BATCH}); a "
                  f"forward {st['batch_ms']:.3f} ms on the card, "
                  f"{st['host_ms']:.3f} ms to enqueue ({card})")

        # --- 5. cli distill-steps (10 -> 5 -> 3), then the students'
        # int8_deep bundles
        fcommon = [*common, "--features", str(FEATURES)]
        t0 = time.perf_counter()
        report, counts = count_launches(lambda: cli.main([
            "distill-steps", "--teacher", "fastddpm", "--rounds", "2",
            "--factor", "2", "--epochs", "1", "--max-eval-batches",
            str(STEP_EVAL_BATCHES), *fcommon]))
        walls["cli distill-steps"] = time.perf_counter() - t0
        add_counts(launches, counts)
        if counts["ssim"] <= 0:
            raise AssertionError("K1 was not launched by distill-steps' eval")
        names = {"teacher", "fastddpm_steps5", "fastddpm_steps3"}
        if set(report) != names:
            raise AssertionError(f"distill-steps report {sorted(report)}")
        for n in (5, 3):
            entry = report[f"fastddpm_steps{n}"]
            with open(os.path.join(models_dir,
                                   f"fastddpm_steps{n}_grid.json")) as f:
                grid = json.load(f)
            if len(grid["timesteps"]) != n or not all(np.isfinite(
                    entry["history"]["train_loss"])):
                raise AssertionError(f"fastddpm_steps{n}: {grid} {entry}")
            print(f"fastddpm_steps{n}: grid {grid['timesteps']}, train loss "
                  f"{entry['history']['train_loss']}, val "
                  f"{entry['history']['val_loss']}; SSIM 3 mm "
                  f"{entry['eval']['3mm']['ssim_mean']:.6f} (vs the 10-step "
                  f"teacher {entry['ssim_delta_vs_teacher_3mm']:+.6f}), 6 mm "
                  f"{entry['eval']['6mm']['ssim_mean']:.6f} "
                  f"({entry['ssim_delta_vs_teacher_6mm']:+.6f})")
        results["distill_steps"] = report
        fd = load_model("fastddpm", models_dir, checkpoint="required",
                        cfg=fast_mcfg, device=dev)
        step_fn = make_stepdistill_steps(fd.schedule, 2,
                                         frozen_bf16_teacher(fd.module))[0]
        state = create_train_state(
            copy.deepcopy(fd.module).requires_grad_(True), TrainConfig(
                optimizer="adamw", learning_rate=2e-5, weight_decay=1e-4,
                grad_clip_norm=1.0))
        x4 = next(iter(build_loader(store, "train", dataclasses.replace(
            PRESETS["fastddpm"].data, image_size=(HW, HW)), device=dev)))
        gen = torch.Generator(device=dev).manual_seed(0)
        sd_ms = cuda_ms(lambda: step_fn(state, x4, gen), reps=3, warmup=1)
        sd_host = host_us(lambda: step_fn(state, x4, gen), calls=3) / 1e3
        results["stepdistill_step"] = {"batch": int(x4.shape[0]),
                                       "ms": sd_ms, "host_ms": sd_host}
        print(f"step-distill step (fastddpm, factor 2, batch "
              f"{x4.shape[0]}, float32): {sd_ms:.3f} ms on the card, "
              f"{sd_host:.3f} ms of host time ({card})")
        del fd, state, step_fn

        t0 = time.perf_counter()
        sampler = {}
        x8 = torch.from_numpy(requests[:BATCH]).to(dev)
        for name, n in (("fastddpm", 10), ("fastddpm_steps5", 5),
                        ("fastddpm_steps3", 3)):
            bundles[name] = os.path.join(work, f"bundle_{name}")
            cli.main(["export-serving", "--model", name, *fcommon, "--quant",
                      "int8_deep", "--batch-size", str(BATCH),
                      "--calib-batches", "2", "--out", bundles[name]])
            params, meta = load_bundle(bundles[name])
            want = "ancestral" if n == 10 else "ddim_grid"
            if meta["sampler"] != want or len(
                    params["schedule"]["timesteps"]) != n:
                raise AssertionError(f"{name} bundle meta {meta}")
            if n < 10:
                results[f"serving {name}"], counts = serve_trained(
                    name, bundles[name], requests[:DIFF_REQUESTS], dev,
                    models_dir, fast_mcfg, steps=n)
                add_counts(launches, counts)
            apply = make_bundle_apply(params, meta, dev)
            ms = cuda_ms(lambda: apply(x8), reps=3, warmup=1)
            sampler[name] = {"steps": n, "ms": ms,
                             "slices_per_s": BATCH / ms * 1e3}
            print(f"{name} int8_deep sampler ({meta['sampler']}, {n} steps, "
                  f"batch {BATCH}): {ms:.2f} ms a call on the card = "
                  f"{BATCH / ms * 1e3:.2f} slices/s ({card})")
        results["sampler"] = sampler
        walls["export + serve step students"] = time.perf_counter() - t0

        # --- 6. cli serve's front end over HTTP
        t0 = time.perf_counter()
        http = {}
        for name in ("unet_distilled", "fastddpm_steps5"):
            http[name], counts = http_check(bundles[name], requests, dev,
                                            name)
            add_counts(launches, counts)
        results["http"] = http
        walls["http"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    results["wall_s"], results["launches"] = walls, launches
    for kernel in ("ssim", "conv_int8", "upconv_int8", "groupnorm_silu"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{kernel} was not launched in phase 11")
    print(f"distill phase launches {launches}")
    print("distill wall (s): " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in walls.items()))
    return launches, results


INGEST_PATIENTS, INGEST_SLICES = 12, 60  # the dataset's T2 series shape
INGEST_Z_MM = 1.5
INGEST_MODELS = ("unet_combined", "deepcnn", "progressive_unet")
COMPARE_BATCHES = 2  # compare/eval --max-batches: a few batches a spacing
SCAN_ROUNDS = 3      # the header scan's rate: the best of these passes


# the decoy series, by patient number: (folder, slices, header fields);
# clean removes the US and 3D-rendering ones, pack leaves out the short ones
INGEST_DECOYS = {
    1: ("1.000-US", INGEST_SLICES, {"modality": "US",
                                    "series_description": "US PROSTATE"}),
    2: ("1.000-US", INGEST_SLICES, {"modality": "US",
                                    "series_description": "US PROSTATE"}),
    3: ("4.000-3D", INGEST_SLICES, {"series_description": "T2 3D RENDERING"}),
    4: ("4.000-3D", INGEST_SLICES, {"series_description": "T2 3D RENDERING"}),
    5: ("6.000-t2 short", INGEST_SLICES - 1,
        {"series_description": "t2_tse_tra"}),
    6: ("6.000-t2 short", INGEST_SLICES - 1,
        {"series_description": "t2_tse_tra"}),
}


def write_ingest_tree(root: str):
    """The dataset's layout: INGEST_PATIENTS patients named
    Prostate-MRI-US-Biopsy-00NN, each with one T2 series of INGEST_SLICES
    slices of HW^2 uint16 from the seeded phantom generator (Z 1.5 mm
    apart, pixels 0.664 mm), written by the port's write_dicom, and the
    INGEST_DECOYS series.  Returns ({patient: uint16 volume}, [the series
    folders clean removes])."""
    from mrisr_tpu_torch.data.dicom_lite import write_dicom
    from mrisr_tpu_torch.data.synthetic import make_synthetic_volume

    def series(folder, vol, pid, uid, **kw):
        for z in range(vol.shape[0]):
            write_dicom(os.path.join(folder, f"1-{z + 1:02d}.dcm"), vol[z],
                        patient_id=pid, series_uid=uid,
                        instance_number=z + 1,
                        image_position=(0.0, 0.0, INGEST_Z_MM * z),
                        pixel_spacing=(0.664, 0.664), **kw)

    truth, removed = {}, []
    for p in range(1, INGEST_PATIENTS + 1):
        pid = f"Prostate-MRI-US-Biopsy-{p:04d}"
        study = os.path.join(root, pid, "1.3.6.1-MRI PROSTATE")
        vol = np.clip(np.rint(make_synthetic_volume(
            INGEST_SLICES, HW, HW, seed=100 + p)), 0, 65535).astype(np.uint16)
        truth[pid] = vol
        series(os.path.join(study, "3.000-t2 ax"), vol, pid,
               f"1.2.826.0.1.{p}.3", series_description="t2_tse_tra")
        if p in INGEST_DECOYS:
            name, n, fields = INGEST_DECOYS[p]
            series(os.path.join(study, name), vol[:n], pid,
                   f"1.2.826.0.1.{p}.9", **fields)
            if n == INGEST_SLICES:
                removed.append(os.path.join(study, name))
    return truth, removed


def ingest_phase(dev, card: str, teachers: str):
    """DICOM ingest and export, comparison tables and figures at the size
    of the real data's series (see the module docstring, item 12):
    ``teachers`` holds phase 8's unet_combined_best.pt and phase 9's
    deepcnn_best.pt and progressive_unet_best.pt.  Returns (launches,
    results)."""
    import csv
    import zipfile

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.data import dicom_fast
    from mrisr_tpu_torch.data.clean import scan_dataset
    from mrisr_tpu_torch.data.dicom_lite import parse_dicom_bytes, read_dicom
    from mrisr_tpu_torch.data.discovery import (
        check_z_spacing, read_series_volume)
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.ops.ssim import ssim

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        return out

    def main_path(fn):
        # the user's entry point with every count from 0 just before it
        out, counts = count_launches(fn)
        add_counts(launches, counts)
        return out

    def series_dirs(root):
        return {d for d, _, files in os.walk(root)
                if any(f.endswith(".dcm") for f in files)}

    with tempfile.TemporaryDirectory() as work:
        # --- 1. the tree, zipped as the download comes
        tree = os.path.join(work, "tree", "Prostate-MRI-US-Biopsy")
        truth, decoys = timed("write tree", lambda: write_ingest_tree(tree))
        zpath = os.path.join(work, "Prostate-MRI-US-Biopsy.zip")

        def zip_tree():
            with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED,
                                 compresslevel=1) as zf:
                for d in sorted(series_dirs(tree)):
                    for f in sorted(os.listdir(d)):
                        full = os.path.join(d, f)
                        zf.write(full, os.path.relpath(full, os.path.dirname(
                            tree)))
        timed("zip", zip_tree)
        n_files = sum(len(os.listdir(d)) for d in series_dirs(tree))
        shutil.rmtree(os.path.join(work, "tree"))
        results["tree"] = {"patients": INGEST_PATIENTS, "files": n_files,
                           "zip_mb": os.path.getsize(zpath) / 2 ** 20}
        print(f"ingest tree: {INGEST_PATIENTS} patients x {INGEST_SLICES} x "
              f"{HW}^2 uint16 + 6 decoy series = {n_files} files, zip "
              f"{results['tree']['zip_mb']:.1f} MiB")

        # --- 2. extract -> clean --dry-run -> clean --yes -> pack
        out = os.path.join(work, "extracted")
        root = os.path.join(out, "Prostate-MRI-US-Biopsy")
        timed("cli extract", lambda: cli.main(["extract", zpath, out]))
        before = series_dirs(root)
        if len(before) != INGEST_PATIENTS + 6:
            raise AssertionError(f"extract gave {len(before)} series")

        # --- 3. the native scanner against the Python parser, every file
        if not dicom_fast.available():
            raise AssertionError("the native DICOM scanner did not build")
        files = sorted(os.path.join(d, f) for d in before
                       for f in os.listdir(d))
        blobs = [open(f, "rb").read() for f in files]
        for f, b in zip(files, blobs):
            want = parse_dicom_bytes(b, pixels=False).fields
            if dicom_fast.parse_dicom_bytes_fast(b, pixels=False).fields \
                    != want:
                raise AssertionError(f"native header of {f} differs")
        rates = {}
        for label, parse in (("python", parse_dicom_bytes),
                             ("native", dicom_fast.parse_dicom_bytes_fast)):
            best = float("inf")
            for _ in range(SCAN_ROUNDS):
                t0 = time.perf_counter()
                for b in blobs:
                    parse(b, pixels=False)
                best = min(best, time.perf_counter() - t0)
            rates[label] = len(blobs) / best
        del blobs
        results["header_scan_files_per_s"] = rates
        print(f"header scan (host CPU, pixels=False, {len(files)} files in "
              f"memory, best of {SCAN_ROUNDS}): python "
              f"{rates['python']:.0f} files/s, native {rates['native']:.0f} "
              f"files/s ({rates['native'] / rates['python']:.2f}x); the "
              f"host's numbers, not the card's")

        listed = scan_dataset(root)
        if sorted(t.path for t in listed[0]) != sorted(
                os.path.join(out, os.path.relpath(d, os.path.join(
                    work, "tree"))) for d in decoys):
            raise AssertionError(f"scan_dataset listed {listed[0]}")
        timed("cli clean --dry-run",
              lambda: cli.main(["clean", root, "--dry-run"]))
        if series_dirs(root) != before:
            raise AssertionError("clean --dry-run deleted a series")
        timed("cli clean --yes", lambda: cli.main(["clean", root, "--yes"]))
        removed = before - series_dirs(root)
        if sorted(removed) != sorted(t.path for t in listed[0]):
            raise AssertionError(f"clean removed {sorted(removed)}")
        store_dir = os.path.join(work, "store")
        timed("cli pack", lambda: cli.main(["pack", root, store_dir, "--slices",
                                            str(INGEST_SLICES)]))
        store = VolumeStore.open(store_dir)
        if [e.patient_id for e in store.entries] != sorted(truth):
            raise AssertionError(f"packed {[e.series_id for e in store.entries]}")
        for k, e in enumerate(store.entries):
            vol = store.load_series(k, mmap=False)
            if vol.dtype != np.float32 or not np.array_equal(
                    vol, truth[e.patient_id].astype(np.float32)):
                raise AssertionError(f"{e.series_id}: packed volume differs")
            z = check_z_spacing(os.path.join(root, e.series_id))
            if z != INGEST_Z_MM:
                raise AssertionError(f"{e.series_id}: Z spacing {z}")
        print(f"ingest: clean removed {len(removed)} series (2 US, 2 3D "
              f"rendering), pack kept {len(store)} of "
              f"{len(before) - len(removed)} (the 2 {INGEST_SLICES - 1}-slice "
              f"series left out), every volume bit-equal to its uint16 "
              f"source, Z {INGEST_Z_MM} mm")

        # --- 4. predict-volume --export-dicom: unet_combined plain and
        # --hierarchical, the progressive UNet (window kind)
        models_dir = os.path.join(work, "models")
        os.makedirs(models_dir)
        for name in INGEST_MODELS:
            shutil.copy(os.path.join(teachers, f"{name}_best.pt"), models_dir)
        results_dir = os.path.join(work, "results")
        common = ["--data", store_dir, "--checkpoint-dir", models_dir,
                  "--results-dir", results_dir, "--features", str(FEATURES),
                  "--image-size", str(HW), "--batch-size", str(BATCH),
                  "--device", str(dev)]
        volume = {}
        for model, flag in (("unet_combined", []),
                            ("unet_combined", ["--hierarchical"]),
                            ("progressive_unet", [])):
            label = " ".join([model, *flag])
            export = os.path.join(work, "export", label.replace(" ", ""))
            res = timed(f"cli predict-volume {label}", lambda: main_path(
                lambda: cli.main(["predict-volume", "--model", model,
                                  *common, *flag, "--export-dicom",
                                  export])))[model]
            # K1's SSIM per slice against the plain SSIM of the same
            # predictions (outside the counted run)
            m = res["metrics"]
            g = torch.from_numpy(m["orig_norm"]).to(dev)
            q = torch.from_numpy(m["pred_norm"]).to(dev)
            k1 = ssim(g, q, data_range=1.0)
            plain = ssim(g, q, data_range=1.0, use_kernel=False)
            diff = float((k1 - plain).abs().max())
            mean_diff = abs(m["ssim_mean"] - float(plain.mean()))
            if not (diff <= SSIM_ATOL and mean_diff <= SSIM_ATOL):
                raise AssertionError(f"predict-volume {label}: K1 vs plain "
                                     f"{diff} a slice, {mean_diff} the mean")
            # the exported series, read back: the uint16 map, Z 1.5 mm
            pred = res["volume_predicted"]
            lo, hi = float(pred.min()), float(pred.max())
            codes = ((pred - lo) * (65535.0 / (hi - lo + 1e-8))).astype(
                np.uint16)
            back = read_series_volume(os.path.join(export, model))
            z = check_z_spacing(os.path.join(export, model))
            head = read_dicom(os.path.join(export, model, "slice_000.dcm"),
                              pixels=False)
            if not (back is not None and np.array_equal(
                    back, codes.astype(np.float32)) and z == INGEST_Z_MM
                    and head.series_description == f"mrisr-tpu {model} "
                                                   "predicted"):
                raise AssertionError(f"predict-volume {label}: the exported "
                                     f"series differs (Z {z})")
            volume[label] = {
                "ssim": m["ssim_mean"], "psnr": m["psnr_mean"],
                "ssim_predicted_only": res["metrics_predicted_only"][
                    "ssim_mean"], "k1_vs_plain_max": diff,
                "slices": int(pred.shape[0]),
                "predicted": len(res["predicted_indices"])}
            print(f"predict-volume {label}: SSIM {m['ssim_mean']:.6f} over "
                  f"{pred.shape[0]} slices ({len(res['predicted_indices'])} "
                  f"predicted), K1 vs plain {diff:.2g} a slice; exported "
                  f"{pred.shape[0]} slices equal to the uint16 map, Z "
                  f"{z} mm")
        results["predict_volume"] = volume

        # --- 5. compare live, then eval each and compare --from-results
        mcommon = [*common, "--max-batches", str(COMPARE_BATCHES)]
        rows = timed("cli compare (live)", lambda: main_path(
            lambda: cli.main(["compare", "--model", *INGEST_MODELS,
                              *mcommon])))
        for name in INGEST_MODELS:
            timed("cli eval x3", lambda: main_path(lambda: cli.main(
                ["eval", "--model", name, *mcommon])))
        saved = timed("cli compare --from-results", lambda: cli.main(
            ["compare", "--from-results", "--model", *INGEST_MODELS,
             "--results-dir", results_dir]))
        with open(os.path.join(results_dir, "comparison_metrics.csv")) as f:
            table = list(csv.reader(f))
        if [r[0] for r in rows] != list(INGEST_MODELS) or table[0][0] != \
                "Model" or [r[0] for r in table[1:]] != list(INGEST_MODELS):
            raise AssertionError(f"compare rows {rows}, csv {table}")
        for live, kept, line in zip(rows, saved, table[1:]):
            if not all(np.isfinite(v) for v in live[1:]) or any(
                    abs(a - b) > 1e-5 or abs(float(c) - b) > 0
                    for a, b, c in zip(live[1:], kept[1:], line[1:])):
                raise AssertionError(f"compare {live} / from results {kept}"
                                     f" / csv {line}")
        results["compare"] = [list(r) for r in rows]
        print("compare (live, " + f"{COMPARE_BATCHES} batches of {BATCH} a "
              "spacing): " + "; ".join(
                  f"{r[0]} SSIM {r[1]:.4f}/{r[3]:.4f} PSNR {r[2]:.2f}/"
                  f"{r[4]:.2f} (3/6 mm)" for r in rows)
              + "; --from-results rows within 1e-5, CSV equal")

        # --- 6. figures: rendered where matplotlib imports, else refused
        # naming it (tier-1 renders them on the CPU)
        fig = os.path.join(work, "figures")
        figure_runs = (
            ["predict-volume", "--model", "unet_combined",
             "progressive_unet", *common, "--figure",
             os.path.join(fig, "views.png"), "--view", "sagittal"],
            ["triplet-figure", "--model", "unet_combined", "deepcnn",
             *common, "--figure", os.path.join(fig, "triplet.png")])
        try:
            import matplotlib  # noqa: F401
            have_mpl = True
        except ImportError:
            have_mpl = False
        for argv in figure_runs:
            if have_mpl:
                timed(f"cli {argv[0]} --figure", lambda: main_path(
                    lambda: cli.main(argv)))
                if not os.path.getsize(argv[argv.index("--figure") + 1]):
                    raise AssertionError(f"{argv[0]}: empty figure")
                continue
            try:
                cli.main(argv)
            except ImportError as e:
                if "matplotlib" not in str(e):
                    raise
            else:
                raise AssertionError(f"{argv[0]} --figure ran without "
                                     "matplotlib")
            if os.path.exists(fig):
                raise AssertionError(f"{argv[0]} wrote {os.listdir(fig)}")
        results["figures"] = "rendered" if have_mpl else "held on the CPU"
        print("figures: " + ("predict-volume --figure and triplet-figure "
                             "rendered" if have_mpl else
                             "matplotlib is not installed on this machine: "
                             "predict-volume --figure and triplet-figure "
                             "refuse with an ImportError naming it, and "
                             "rendering is held on the CPU (tier-1)"))
    walls["phase"] = time.perf_counter() - t_phase
    results["wall_s"], results["launches"] = walls, launches
    if launches.get("ssim", 0) <= 0:
        raise AssertionError("ssim was not launched in phase 12")
    print(f"ingest phase launches {launches}")
    print("ingest wall (s): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in walls.items())
          + f" ({card})")
    return launches, results


# phase 13: data parallelism.  Two ranks share the one card over gloo
# (NCCL refuses two ranks on one card), each on its half of the global
# batch; the single-process step on the card is the reference.
DP_RANKS = 2
DP_BATCH = 4       # the unet_combined preset's batch: 2 rows a rank
DP_PATIENTS, DP_SLICES = 8, 8
DP_REQUESTS = 16   # served at batch 8
DP_TIMEOUT = 600   # seconds for the rank pair


def dp_rank_main(rank: int, port: int, in_path: str, out_dir: str) -> None:
    """One rank of phase 13's pair (``chip_smoke.py --dp-rank``): the
    unet_combined step and the distill step on this rank's rows (phase 16:
    the unet_combined step plain and with remat), with the kernels' launch
    counts of each."""
    sys.path.insert(0, ROOT)
    from mrisr_tpu_torch.config import Config
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.parallel.mesh import (
        distributed_init, make_mesh, shard_batch)
    from mrisr_tpu_torch.serve import Int8FusedUNet
    from mrisr_tpu_torch.serve.distill import DistillationTrainer
    from mrisr_tpu_torch.train import SupervisedTrainer

    inputs = torch.load(in_path, weights_only=False)
    dev = torch.device(inputs["device"])
    distributed_init(f"localhost:{port}", DP_RANKS, rank, backend="gloo")
    mesh = make_mesh(device=dev)
    out = {}
    cases = list(inputs["configs"].items())
    if inputs.get("same_bits"):
        # phase 16 compares two steps' running statistics bit for bit:
        # deterministic algorithms, and a warm-up step first, since cuDNN
        # gives a process's first call at dec2.conv.0's shape other bits
        # than every later one (as in phase 14)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        cases.insert(0, ("unet_combined warm-up", cases[0][1]))
    for case, cfg_dict in cases:
        cfg = Config.from_dict(cfg_dict)
        if case.startswith("unet_combined"):  # phase 16: and its remat
            trainer = SupervisedTrainer(
                cfg, perceptual_fn=make_perceptual_fn(cfg.loss.perceptual),
                device=dev, mesh=mesh)
        else:
            teacher = Int8FusedUNet(inputs["qparams"], device=dev)
            trainer = DistillationTrainer(
                cfg, teacher_fn=lambda x: teacher(x).float(), device=dev,
                mesh=mesh)
        batch = shard_batch(inputs["batch"], mesh).to(dev)
        (_, m), counts = count_launches(
            lambda: trainer.train_step(trainer.state, batch))
        if case == "unet_combined warm-up":
            del trainer
            continue
        out[case] = {"loss": float(m["loss"]), "counts": counts,
                     "rows": int(batch.shape[0])}
        if rank == 0:
            out[case].update(step_tensors(trainer.state.module))
        del trainer
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def step_tensors(module):
    """A stepped module's gradients and BatchNorm running statistics, on
    the CPU."""
    return {"grads": {n: p.grad.detach().cpu().double()
                      for n, p in module.named_parameters()},
            "stats": {n: b.detach().cpu().double()
                      for n, b in module.named_buffers() if "running" in n}}


def grad_rel(got, want):
    """Per-tensor rel-L2 of ``got`` against ``want`` (name -> gradient); a
    conv bias right before a training-mode BatchNorm (zero in exact
    arithmetic) is measured against the same conv's weight gradient, as
    ``grad_errors`` measures it."""
    out = {}
    for name, g in got.items():
        conv, _, leaf = name.rpartition(".")
        if leaf == "bias" and conv.endswith((".conv.0", ".conv.3")):
            out[name] = float(g.norm() / want[conv + ".weight"].norm())
        else:
            out[name] = float((g - want[name]).norm() / want[name].norm())
    return out


def dp_step_check(what, single, rank0, loss_dp, ref64,
                  mine=f"{DP_RANKS}-rank step",
                  theirs="the single-process step on the card"):
    """Phase 8's bounds for the DP step against the single-process step on
    the card: the loss within rel 1e-4, the BN running statistics within
    1e-4, each gradient within rel-L2 1e-3 or, past it, within
    GRAD_NOISE_FACTOR times the single step's own float32 error against
    the same step in float64 on the CPU (``ref64()``, run only then)."""
    loss_rel = abs(loss_dp - single["loss"]) / abs(single["loss"])
    stats_err = max((float((rank0["stats"][n] - s).abs().max())
                     for n, s in single["stats"].items()), default=0.0)
    errs = grad_rel(rank0["grads"], single["grads"])
    over = {n: e for n, e in errs.items() if not e <= GRAD_RTOL}
    bound = {n: GRAD_RTOL for n in errs}
    if over:
        noise = grad_rel(single["grads"], ref64())
        for n in over:
            bound[n] = max(GRAD_RTOL, GRAD_NOISE_FACTOR * noise[n])
    failed = [n for n, e in errs.items() if not e <= bound[n]]
    worst = max(errs, key=errs.get)
    print(f"{what}: {mine} vs {theirs}: loss {single['loss']:.9f}, rel "
          f"{loss_rel:.3g} (bound "
          f"1e-4); BN running stats max |diff| {stats_err:.3g} (bound "
          f"1e-4); gradient rel-L2 worst {errs[worst]:.3g} ({worst}), "
          f"{len(over)} of {len(errs)} over {GRAD_RTOL:g}"
          + (f", each within {GRAD_NOISE_FACTOR:g}x the single step's "
             "float32 error vs float64" if over and not failed else ""))
    if not loss_rel <= 1e-4:
        raise AssertionError(f"{what} DP loss rel {loss_rel}")
    if not stats_err <= 1e-4:
        raise AssertionError(f"{what} DP BN running stats {stats_err}")
    if failed:
        raise AssertionError(f"{what} DP gradients past their bound: "
                             f"{[(n, errs[n], bound[n]) for n in failed]}")
    return {"loss_rel": loss_rel, "bn_stats_err": stats_err,
            "grad_rel_l2_max": errs[worst], "grads_over_1e-3": len(over)}


def run_dp_ranks(inputs, work):
    """Phase 13's rank pair (this script with ``--dp-rank``), both stopped
    before it returns; returns each rank's results.  ``inputs["same_bits"]``
    (phase 16): the ranks run deterministic algorithms, cuBLAS's included,
    and take a warm-up step first."""
    import socket

    in_path = os.path.join(work, "dp_inputs.pt")
    torch.save(inputs, in_path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8") if inputs.get(
        "same_bits") else None
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--dp-port", str(port), "--dp-in", in_path, "--dp-out", work],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_RANKS)]
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"DP rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_RANKS)]


# dispatcher ops that allocate without writing: a kernel fills their
# outputs after they return, so their values say nothing
ALLOCATING = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def bits_fingerprint(v: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over the bit patterns of ``v``, plain and weighted by
    position (on v's device, no sync): equal tensors give equal pairs, and
    a changed bit changes them."""
    v = v.detach().contiguous().reshape(-1)
    if v.is_floating_point():
        v = v.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[v.element_size()])
    v = v.to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return torch.stack([v.sum(), (v * w).sum()])


def op_trace(fn, keep: int, capture_at: int = -1):
    """Runs ``fn`` under a dispatch mode.  Returns, one entry an output
    tensor of every dispatcher op: its name (with the output's position
    where it has several), its shape, and the fingerprints of its inputs'
    and its output's first ``keep`` rows along their first dims; and those
    rows of the ``capture_at``-th entry's output."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    ops, caught = [], []

    def first(o):
        return o[:keep] if o.dim() else o

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ALLOCATING:
                return out
            ins = [bits_fingerprint(first(a)) for a in tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)]
            ins = torch.stack(ins) if ins else torch.zeros(0, 2)
            outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
            for k, o in enumerate(outs):
                if len(ops) == capture_at:
                    caught.append(first(o).detach().clone())
                ops.append((f"{name}[{k}]" if len(outs) > 1 else name,
                            tuple(o.shape), ins, bits_fingerprint(first(o))))
            return out

    with Trace():
        fn()
    return ([(name, shape, ins.cpu(), out.cpu())
             for name, shape, ins, out in ops], caught)


def row_witness(fwd, x, t, what: str):
    """Where ``fwd`` (a :class:`FastDDPMForward`) computes its first
    ``x.shape[0] // 2`` rows differently when it runs all of ``x``: every
    conv input (the forward's ``stats`` hook, with ``stat_fn`` a copy) and
    the time embedding at both row counts; then, over every dispatcher op,
    the first whose inputs' first rows are the same at both counts and
    whose output's are not.  Prints both with the max |diff| and returns
    them (a kernel's output shows at the site that reads it)."""
    n = x.shape[0]
    half = n // 2
    sites, outs = {}, {}
    for rows in (n, half):
        stats = {}
        t_emb = fwd.time_embedding(t[:rows])
        outs[rows] = fwd(x[:rows], t[:rows], stats=stats,
                         stat_fn=lambda h: h.detach().clone())
        sites[rows] = {"time embedding": t_emb, **stats}
    site, site_diff = None, 0.0
    for name, v in sites[n].items():
        a, b = v[:half].float(), sites[half][name].float()
        if not torch.equal(a, b):
            site, site_diff = name, float((a - b).abs().max())
            break
    out_diff = float((outs[n][:half] - outs[half]).abs().max())
    traces = {rows: op_trace(lambda: fwd(x[:rows], t[:rows]), half)[0]
              for rows in (n, half)}
    # pair the ops of the two runs by name and inputs (a forward that
    # loops over rows runs more ops at n rows), then look for an output
    # that differs
    keys = {rows: [(o[0], o[2].numpy().tobytes()) for o in tr]
            for rows, tr in traces.items()}
    pairs = [(i + k, j + k) for i, j, size in difflib.SequenceMatcher(
        None, keys[n], keys[half], autojunk=False).get_matching_blocks()
        for k in range(size)]
    differ = [(i, j) for i, j in pairs
              if not torch.equal(traces[n][i][3], traces[half][j][3])]
    op = None
    if differ:
        i, j = differ[0]
        got = {rows: op_trace(lambda: fwd(x[:rows], t[:rows]), half,
                              capture_at=k)[1][0].float()
               for rows, k in ((n, i), (half, j))}
        op = {"index": i, "of": len(traces[n]), "op": traces[n][i][0],
              "shape": traces[n][i][1],
              "before": [o[0] for o in traces[n][max(0, i - 3):i]],
              "max_abs_diff": float((got[n] - got[half]).abs().max()),
              "pairs": len(pairs)}
    result = {"first_site": site, "site_max_abs_diff": site_diff,
              "first_op": op, "output_max_abs_diff": out_diff,
              "sites": list(sites[n])}
    print(f"{what}: rows 0-{half - 1} at {half} rows vs at {n}: first conv "
          f"input that differs {site!r} (max |diff| {site_diff:.6g}); first "
          f"op that differs on the same inputs {op}; the output's max "
          f"|diff| {out_diff:.6g}")
    return result


def parallel_phase(dev, card: str, teachers: str):
    """Data parallelism (see the module docstring, item 13): ``teachers``
    holds phase 8's unet_combined_best.pt and phase 9's fastddpm_best.pt.
    Returns (launches, results)."""
    import dataclasses

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.ops.conv_int8 import conv_path
    from mrisr_tpu_torch.ops.upconv import upconv_path
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, engine_from_bundle, load_bundle, make_bundle_apply)
    from mrisr_tpu_torch.serve.distill import DistillationTrainer
    from mrisr_tpu_torch.serve.engine import _rows_to
    from mrisr_tpu_torch.serve.quant import calibrate_unet, quantize_unet
    from mrisr_tpu_torch.train import SupervisedTrainer

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()
    unet_paths = {
        "conv_int8": path_counts(conv_sites(FEATURES), lambda st: conv_path(
            st[2], st[3], st[4])),
        "upconv_int8": path_counts(upconv_sites(FEATURES), lambda st:
                                   upconv_path(st[2], st[3]))}
    with tempfile.TemporaryDirectory() as work:
        store_dir = os.path.join(work, "store")
        t0 = time.perf_counter()
        cli.main(["synth", store_dir, "--patients", str(DP_PATIENTS),
                  "--slices", str(DP_SLICES), "--size", str(HW)])
        store = VolumeStore.open(store_dir)

        # --- (a) and (b): the unet_combined and distill steps, single
        # process on the card and two ranks on it, on one global batch
        base = PRESETS["unet_combined"]
        ucfg = base.replace(
            data=dataclasses.replace(base.data, image_size=(HW, HW),
                                     batch_size=DP_BATCH, augment=False),
            model=dataclasses.replace(base.model, base_features=FEATURES))
        dbase = PRESETS["unet_distilled"]
        dcfg = dbase.replace(
            data=dataclasses.replace(dbase.data, image_size=(HW, HW),
                                     batch_size=DP_BATCH, augment=False),
            model=dataclasses.replace(dbase.model,
                                      base_features=FEATURES // 2),
            train=dataclasses.replace(dbase.train, compute_dtype="float32"),
            loss=dataclasses.replace(dbase.loss, distill_lambda_ssim=0.1,
                                     distill_ema=0.999))
        batch = next(iter(build_loader(store, "train", ucfg.data,
                                       device="cpu")))
        calib = [b[..., :2] for b, _ in zip(
            build_loader(store, "val", ucfg.data, device=dev), range(2))]
        # the int8_fused teacher (distill --teacher-quant int8_fused),
        # calibrated on two val batches; its tables go to the ranks
        folded = load_model("unet_combined", teachers, checkpoint="required",
                            cfg=dataclasses.replace(ucfg.model,
                                                    name="unet_combined"),
                            fold_bn=True, device=dev).module
        qparams = quantize_unet(folded, calibrate_unet(folded, calib))
        teacher = Int8FusedUNet(qparams, device=dev)
        xb = batch.to(dev)
        single = {}
        perceptual = make_perceptual_fn(ucfg.loss.perceptual)
        for case, cfg in (("unet_combined", ucfg), ("distill", dcfg)):
            trainer = (SupervisedTrainer(cfg, perceptual_fn=perceptual,
                                         device=dev)
                       if case == "unet_combined" else DistillationTrainer(
                           cfg, teacher_fn=lambda x: teacher(x).float(),
                           device=dev))
            _, m = trainer.train_step(trainer.state, xb)
            single[case] = {"loss": float(m["loss"]),
                            **step_tensors(trainer.state.module)}
            del trainer
        walls["single-process steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_dp_ranks({"device": str(dev), "batch": batch,
                              "qparams": qparams, "configs": {
                                  "unet_combined": json.loads(ucfg.to_json()),
                                  "distill": json.loads(dcfg.to_json())}},
                             work)
        walls["2-rank steps (spawn included)"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        def ref64(case):
            def run():
                cfg = ucfg if case == "unet_combined" else dcfg
                if case == "unet_combined":
                    tr = SupervisedTrainer(cfg, perceptual_fn=(
                        make_perceptual_fn(cfg.loss.perceptual,
                                           dtype=torch.float64)),
                        device="cpu")
                else:
                    t_pred = teacher(xb[..., :2]).double().cpu()
                    tr = DistillationTrainer(cfg, teacher_fn=lambda x: t_pred,
                                             device="cpu")
                tr.state.module.double()
                if case == "distill":
                    tr.state.seed_ema()
                tr.train_step(tr.state, batch.double())
                return {n: p.grad.detach().double()
                        for n, p in tr.state.module.named_parameters()}
            return run

        for case in ("unet_combined", "distill"):
            losses = [r[case]["loss"] for r in ranks]
            if losses[0] != losses[1]:
                raise AssertionError(f"{case}: the ranks report {losses}")
            if [r[case]["rows"] for r in ranks] != [DP_BATCH // DP_RANKS] * 2:
                raise AssertionError(f"{case}: rows a rank "
                                     f"{[r[case]['rows'] for r in ranks]}")
            results[case] = dp_step_check(case, single[case], ranks[0][case],
                                          losses[0], ref64(case))
            rank_counts = [r[case]["counts"] for r in ranks]
            for c in rank_counts:
                add_counts(launches, c)
            if case == "distill":
                for r, c in enumerate(rank_counts):
                    # the int8_fused teacher on the rank's rows: one forward
                    expect_launches(c, {"conv_int8": 19, "upconv_int8": 4}, 1,
                                    f"distill rank {r}")
                    check_paths(c, unet_paths, 1, f"distill rank {r}")
                results[case]["launches_by_rank"] = rank_counts
        n_params = sum(g.numel() for g in
                       single["unet_combined"]["grads"].values())
        if n_params != UNET_PARAMS:
            raise AssertionError(f"UNet has {n_params} parameters")
        walls["checks"] = time.perf_counter() - t0

        # --- (c) the CLI under torchrun with one rank: the launcher's
        # environment, the card of LOCAL_RANK, no process group (one rank
        # is the unmeshed program), one checkpoint set; narrow (the width
        # is (a)'s), so it costs the launch.  --mesh-data 2 then refuses
        # with the JAX CLI's message, in this process (one rank here too)
        t0 = time.perf_counter()
        cli_features = 8
        train_args = ["train", "--preset", "unet_combined", "--data",
                      store_dir, "--features", str(cli_features),
                      "--image-size", str(HW), "--epochs", "1",
                      "--checkpoint-dir", os.path.join(work, "cli_models"),
                      "--results-dir", os.path.join(work, "cli_results"),
                      # the default device is the card (a CPU rehearsal asks)
                      *([] if dev.type == "cuda" else ["--device", "cpu"])]
        env = dict(os.environ, PYTHONPATH=ROOT)
        one = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "mrisr_tpu_torch", *train_args,
             "--mesh-data", "1"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        if one.returncode != 0:
            raise AssertionError(f"torchrun train --mesh-data 1 exited "
                                 f"{one.returncode}:\n{one.stderr[-4000:]}")
        files = sorted(os.listdir(os.path.join(work, "cli_models")))
        want_files = [f"unet_combined_{s}.pt"
                      for s in ("best", "epoch_1", "latest")]
        if files != want_files:
            raise AssertionError(f"torchrun train wrote {files}")
        refusal = "requests 2x1 devices but only 1 is visible"
        try:
            cli.main([*train_args, "--mesh-data", "2"])
            refused = "ran"
        except SystemExit as e:
            refused = str(e)
        if refusal not in refused:
            raise AssertionError(f"train --mesh-data 2: {refused}")
        print(f"cli train under torchrun, 1 rank, features {cli_features}: "
              f"--mesh-data 1 wrote {files}; --mesh-data 2 refused "
              f"('{refusal}')")
        walls["torchrun cli"] = time.perf_counter() - t0

        # --- (d) data-parallel serving of the int8_fused pair bundle and
        # the int8_deep Fast-DDPM bundle
        t0 = time.perf_counter()
        bundles = {}
        common = ["--data", store_dir, "--image-size", str(HW),
                  "--features", str(FEATURES), "--checkpoint-dir", teachers,
                  "--device", str(dev), "--batch-size", str(BATCH),
                  "--calib-batches", "2"]
        for model, quant in (("unet_combined", "int8_fused"),
                             ("fastddpm", "int8_deep"), ("fastddpm", "none")):
            bundles[model, quant] = os.path.join(work, f"{model}_{quant}")
            cli.main(["export-serving", "--model", model, "--quant", quant,
                      "--out", bundles[model, quant], *common])
        walls["export bundles"] = time.perf_counter() - t0
        loader = build_loader(store, "train", ucfg.data, device="cpu")
        requests = np.concatenate([b[..., :2].numpy() for b, _ in zip(
            loader, range(DP_REQUESTS // DP_BATCH))])

        def serve(bundle, steps=1, **kw):
            with engine_from_bundle(bundle, batch_size=BATCH, device=dev,
                                    max_delay_ms=50.0, **kw) as eng:
                eng.predict(requests[0])
                eng.reset_stats()
                ys, counts = count_launches(
                    lambda: np.stack(eng.predict_many(list(requests))))
                return ys, counts, eng.stats.batches * steps

        t0 = time.perf_counter()
        pair = bundles["unet_combined", "int8_fused"]
        plain_y, _, _ = serve(pair)
        serving = {}
        for label, kw, replicas in (
                ("data_parallel=True (every visible card)",
                 {"data_parallel": True}, 1),
                (f"data_parallel=True, devices=[{dev}, {dev}]",
                 {"data_parallel": True, "devices": [dev, dev]}, 2)):
            y, counts, forwards = serve(pair, **kw)
            equal = bool(np.array_equal(y, plain_y))
            print(f"int8_fused pair bundle, {label}: {len(y)} requests, "
                  f"bit-identical with the plain engine: {equal}; "
                  f"launches {counts}")
            if not equal:
                raise AssertionError(f"DP pair engine ({label}) differs: "
                                     f"max {np.abs(y - plain_y).max()}")
            check_paths(counts, unet_paths, forwards * replicas,
                        f"DP pair serving ({label})")
            add_counts(launches, counts)
            serving[label] = {"bit_identical": equal,
                              "replicas": replicas}
        deep = bundles["fastddpm", "int8_deep"]
        single_y, _, _ = serve(deep, steps=10)
        dp_y, counts, forwards = serve(deep, steps=10, data_parallel=True,
                                       devices=[dev, dev])
        expect_launches(counts, {"groupnorm_silu": 15, "conv_int8": 14,
                                 "upconv_int8": 2}, forwards * 2,
                        "DP int8_deep serving")
        add_counts(launches, counts)
        float_apply = make_bundle_apply(*load_bundle(
            bundles["fastddpm", "none"]), dev)
        x = torch.from_numpy(requests).to(dev)
        y_float = torch.cat([float_apply(x[i:i + BATCH])
                             for i in range(0, len(x), BATCH)]).cpu().numpy()
        rel = rel_rmse(dp_y, y_float)
        diff = float(np.abs(dp_y - single_y).max())
        rel_single = rel_rmse(dp_y, single_y)
        # the witness of that difference: one replica's sampler on the same
        # batches, with its own draws, with the global batch's noise given
        # (BATCH rows, as the single engine runs), and split in two halves
        # on their rows of that noise (as each replica runs).  Each must be
        # bit-identical with its engine; then all that parts the engines is
        # the rows one forward runs (its float sites' algorithms)
        one = make_bundle_apply(*load_bundle(deep), dev)
        half = BATCH // 2
        own, given, split = [], [], []
        for i in range(0, len(x), BATCH):
            xi = x[i:i + BATCH]
            noise = one.draw_noise(BATCH, HW, HW)
            own.append(one(xi))
            given.append(one(xi, noise=noise))
            split += [one(xi[r], noise=_rows_to(noise, r, dev)) for r in (
                slice(0, half), slice(half, BATCH))]
        own, given, split = (torch.cat(v).cpu().numpy()
                             for v in (own, given, split))
        witness = {
            "own draws == single engine": bool(np.array_equal(own, single_y)),
            "given noise == own draws": bool(np.array_equal(given, own)),
            f"{half}-row halves == DP engine": bool(
                np.array_equal(split, dp_y))}
        rel_rows = rel_rmse(split, own)
        print(f"int8_deep witness, one replica's sampler: {witness}; "
              f"{half}-row halves vs {BATCH}-row batches rel-RMSE "
              f"{rel_rows:.6g}, max |diff| "
              f"{float(np.abs(split - own).max()):.6g}")
        if not all(witness.values()):
            raise AssertionError(f"DP int8_deep witness failed: {witness}")
        # one denoiser call at BATCH rows and at its first half: every conv
        # input and every op must give those rows the same bits (K3, at all
        # 15 GroupNorm sites, sums a sample's own pixels in double); the
        # bf16 bundle's is printed
        x_in = torch.cat([x[:BATCH], one.draw_noise(BATCH, HW, HW)[0]], -1)
        t_in = torch.full((BATCH,), int(one.eps_fn.timesteps[-1]),
                          dtype=torch.int32, device=dev)
        rows = row_witness(one.eps_fn, x_in, t_in,
                           "int8_deep denoiser (each replica's forward)")
        if rows["first_site"] or rows["first_op"] or rows[
                "output_max_abs_diff"]:
            raise AssertionError(f"int8_deep denoiser rows differ by the "
                                 f"row count: {rows}")
        rows_bf16 = row_witness(float_apply.eps_fn, x_in, t_in,
                                "bf16 denoiser (the none bundle)")
        if not np.array_equal(dp_y, single_y):
            raise AssertionError(f"DP int8_deep engine differs from the "
                                 f"single engine: max |diff| {diff}")
        rel_single_float = rel_rmse(single_y, y_float)
        print(f"int8_deep Fast-DDPM bundle, data_parallel=True over "
              f"[{dev}, {dev}]: vs the bf16 float sampler rel-RMSE "
              f"{rel:.6f} (bound 0.35; the single engine "
              f"{rel_single_float:.6f}); vs the single engine max |diff| "
              f"{diff:.6g} (|sample| max "
              f"{np.abs(single_y).max():.6g}), rel-RMSE {rel_single:.6g}; "
              f"launches {counts}")
        if not np.isfinite(dp_y).all() or not rel < 0.35:
            raise AssertionError(f"DP int8_deep vs float sampler {rel}")
        serving["int8_deep 2 replicas"] = {
            "rel_rmse_float": rel, "max_diff_single": diff,
            "rel_rmse_single": rel_single,
            "rel_rmse_float_single": rel_single_float,
            "witness": witness, "rel_rmse_rows": rel_rows,
            "bit_identical": True, "rows_int8_deep": rows,
            "rows_bf16": rows_bf16}
        results["serving"] = serving
        walls["dp serving"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    results["walls"] = walls
    for kernel in ("conv_int8", "upconv_int8", "groupnorm_silu"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"{kernel} was not launched in phase 13")
    print(f"parallel phase launches {launches}")
    print("parallel wall (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items())
          + f" ({card}; two ranks share one card: not a scaling number)")
    return launches, results


# phase 14: the 'model' mesh axis.  Four ranks share the one card over
# gloo (this script with --tp-rank): a 2 x 2 mesh over all four runs a
# warm-up step and then one training step, the 2 x 1 meshes over ranks 0
# and 1 (phase 13's pair) and over ranks 2 and 3 the same step as the
# reference, and a 1 x 2 mesh over ranks 0 and 1 the column-parallel
# forwards.
TP_RANKS = 4
TP_STEP_BATCH = 4     # the unet_combined preset's batch: 2 rows a data rank
TP_TIMESTEP = 500     # the Fast-DDPM forward's one timestep
TP_REL_L2 = 1e-4      # sharded vs single-process forward: float32 rounding
                      # of other cuDNN algorithms at half C_out, 23 layers
TP_SITE_FLAG = 10.0   # report a sharded conv over this many times its bound
TP_TIMEOUT = 600      # seconds for the four ranks
# (rank, step) whose own gradients the witness keeps: the rows 0-1 of rank
# 0's three steps, the rows 2-3 of rank 1's pair and rank 2's 2 x 2 step,
# and the pair over ranks 2 and 3
TP_WITNESS = {(0, "warm-up"), (0, "2x2"), (0, "pair"), (1, "pair"),
              (2, "2x2"), (2, "pair23"), (3, "pair23")}


def tp_models():
    """Phase 14's forwards: (name, seeded module, its inputs on the CPU)
    at full width, batch 8, 256^2."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn(BATCH, HW, HW, 2, generator=g)
    xd = torch.randn(BATCH, HW, HW, 3, generator=g)
    t = torch.full((BATCH,), TP_TIMESTEP, dtype=torch.int32)
    return (("unet", seeded_unet(5), (x,)),
            ("fastddpm", seeded_fastddpm(6), (xd, t)))


def tp_rank_main(rank: int, port: int, in_path: str, out_dir: str) -> None:
    """One rank of phase 14 (``chip_smoke.py --tp-rank``): the warm-up and
    the 2 x 2 step (all), the pair's step (on ranks 0 and 1, and on 2 and
    3), then the sharded forwards (ranks 0 and 1), with the kernels'
    launch counts."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.config import Config
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.parallel.mesh import (
        MeshSpec, distributed_init, make_mesh, param_shardings, shard_batch,
        shard_module)
    from mrisr_tpu_torch.train import SupervisedTrainer

    inputs = torch.load(in_path, weights_only=False)
    dev = torch.device(inputs["device"])
    distributed_init(f"localhost:{port}", TP_RANKS, rank, backend="gloo")
    meshes = {"1x2": make_mesh(MeshSpec(data=1, model=2), devices=[0, 1],
                               device=dev),
              "2x2": make_mesh(MeshSpec(data=2, model=2), device=dev),
              "pair": make_mesh(MeshSpec(data=2), devices=[0, 1],
                                device=dev),
              "pair23": make_mesh(MeshSpec(data=2), devices=[2, 3],
                                  device=dev)}
    out = {"forward": {}, "step": {}}

    def run():
        # the model copies run the same program on the same rows:
        # deterministic algorithms (cuBLAS's too, CUBLAS_WORKSPACE_CONFIG
        # in the environment) make it the same bits.  A process's first
        # step is not compared: cuDNN gives its first call at dec2.conv.0's
        # shape other bits than every later one (PERF.md section 7), so
        # each rank takes one warm-up step on the 2 x 2 mesh first, and the
        # sharded forwards run after the steps
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        cfg = Config.from_dict(inputs["config"])
        for label in ("warm-up", "2x2", "pair", "pair23"):
            mesh = meshes["2x2" if label == "warm-up" else label]
            if not mesh.member:
                continue
            trainer = SupervisedTrainer(
                cfg, perceptual_fn=make_perceptual_fn(cfg.loss.perceptual),
                device=dev, mesh=mesh)
            # the witness: this rank's own gradients, before the step's
            # all-reduce over the data group
            local = {}
            hooks = [p.register_post_accumulate_grad_hook(
                lambda p, n=n: local.__setitem__(
                    n, p.grad.detach().cpu().clone()))
                for n, p in trainer.state.module.named_parameters()
            ] if (rank, label) in TP_WITNESS else []
            batch = shard_batch(inputs["batch"], mesh).to(dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, m = trainer.train_step(trainer.state, batch)
            for h in hooks:
                h.remove()
            entry = {"loss": float(m["loss"]), "rows": int(batch.shape[0]),
                     "coords": (mesh.rank, mesh.model_rank), "local": local,
                     "warnings": sorted({str(w.message) for w in caught})}
            if (rank == 0 and label != "warm-up") or (rank, label) in (
                    (1, "2x2"), (2, "pair23")):
                entry.update(step_tensors(trainer.state.module))
            out["step"][label] = entry
            del trainer
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        if meshes["1x2"].member:
            for name, model, args in tp_models():
                model = shard_module(model.to(dev), meshes["1x2"],
                                     param_shardings(model, meshes["1x2"]))
                with torch.no_grad(), fp32_reference():
                    y = model(*(a.to(dev) for a in args)).cpu()
                held = list(model.parameters())
                out["forward"][name] = {
                    "params": sum(p.numel() for p in held),
                    "bytes": sum(p.numel() * p.element_size() for p in held),
                    **({"y": y} if rank == 0 else {})}
                del model

    _, out["counts"] = count_launches(run)
    torch.save(out, os.path.join(out_dir, f"tp_rank{rank}.pt"))
    dist.destroy_process_group()


def run_tp_ranks(inputs, work):
    """Phase 14's four ranks, all stopped before it returns; returns each
    rank's results."""
    import socket

    in_path = os.path.join(work, "tp_inputs.pt")
    torch.save(inputs, in_path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         "--dp-port", str(port), "--dp-in", in_path, "--dp-out", work],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(TP_RANKS)]
    try:
        logs = [p.communicate(timeout=TP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"TP rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    return [torch.load(os.path.join(work, f"tp_rank{r}.pt"),
                       weights_only=False) for r in range(TP_RANKS)]


def conv_fp32_bound(layer, x, y):
    """(bound ms, ops ms, bytes ms) of a float32 conv or transposed conv
    ``layer`` from its input ``x`` to its output ``y`` (NCHW): 2 flops a
    multiply-add on the CUDA cores, x, the weight, the bias and y moved
    once."""
    kh, kw = layer.kernel_size
    c_in = layer.in_channels
    if isinstance(layer, torch.nn.ConvTranspose2d):
        ops = 2.0 * x.numel() * layer.weight.shape[1] * kh * kw
    else:
        ops = 2.0 * y.numel() * c_in // layer.groups * kh * kw
    nbytes = 4.0 * (x.numel() + y.numel() + sum(
        p.numel() for p in layer.parameters()))
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def tp_sites(dev, name, model, args):
    """Each conv that model coordinate 0 of a 'model' axis of 2 keeps
    half of, timed once on its own at the forward's input (float32, TF32
    off) beside its float32 bound; also the single-process forward's
    output.  Returns (y, rows)."""
    import copy

    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.parallel.mesh import (
        Mesh, param_shardings, shard_module)

    model = model.to(dev)
    mesh = Mesh(ranks=[0], rank=0, device=dev, model=2, model_rank=0)
    places = param_shardings(model, mesh)
    # the column block alone: the layers' own forwards skip the hooks that
    # would assemble the output across the group
    sharded = shard_module(copy.deepcopy(model), mesh, places)
    layers = dict(sharded.named_modules())
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: seen.setdefault(n, a[0].clone()))
        for n, m in model.named_modules()
        if isinstance(places.get(f"{n}.weight"), tuple)
        and isinstance(m, torch.nn.modules.conv._ConvNd)]
    with torch.no_grad(), fp32_reference():
        y = model(*(a.to(dev) for a in args))
        for h in hooks:
            h.remove()
        rows = []
        for n, x in seen.items():
            layer = layers[n]
            out = layer.forward(x)
            ms = cuda_ms(lambda: layer.forward(x), reps=5)
            bound, t_ops, t_bytes = conv_fp32_bound(layer, x, out)
            rows.append({"model": name, "site": n, "in": list(x.shape),
                         "out": list(out.shape), "ms": ms,
                         "bound_ms": bound, "over_bound": ms / bound,
                         "bound_by": "operations" if t_ops >= t_bytes
                         else "bytes"})
    del sharded, seen
    return y.cpu(), rows


def grads_diff(got, want):
    """How many of ``got``'s tensors equal ``want``'s bit for bit, and the
    worst rel-L2 of the rest, with the first differing name in ``got``'s
    order (the backward's, for a rank's own gradients)."""
    rel = {n: float((g.double() - want[n].double()).norm()
                    / max(float(want[n].double().norm()), 1e-30))
           for n, g in got.items() if not torch.equal(g, want[n])}
    worst = max(rel, key=rel.get, default=None)
    return {"equal": len(got) - len(rel), "of": len(got),
            "first_diff": next(iter(rel), None), "worst": worst,
            "worst_rel_l2": rel.get(worst, 0.0)}


def tp_phase(dev, card: str):
    """The 'model' mesh axis (see the module docstring, item 14).  Returns
    (launches, results)."""
    import dataclasses

    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    results, walls, launches = {}, {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        # --- (a) the single-process forwards and each sharded conv alone
        t0 = time.perf_counter()
        single, site_rows = {}, []
        for name, model, args in tp_models():
            (single[name], rows), counts = count_launches(
                lambda: tp_sites(dev, name, model, args))
            add_counts(launches, counts)
            site_rows += rows
            del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        walls["single forwards and sites"] = time.perf_counter() - t0
        base = PRESETS["unet_combined"]
        ucfg = base.replace(
            data=dataclasses.replace(base.data, image_size=(HW, HW),
                                     batch_size=TP_STEP_BATCH,
                                     augment=False),
            model=dataclasses.replace(base.model, base_features=FEATURES))
        g = torch.Generator().manual_seed(41)
        batch = torch.randn(TP_STEP_BATCH, HW, HW, 3, generator=g)
        t0 = time.perf_counter()
        ranks = run_tp_ranks({"device": str(dev), "batch": batch,
                              "config": json.loads(ucfg.to_json())}, work)
        walls["4 ranks (spawn included)"] = time.perf_counter() - t0
        for r in ranks:
            add_counts(launches, r["counts"])

        # (a) the column-parallel forwards against the single process
        forward = {}
        for name in ("unet", "fastddpm"):
            want = single[name].numpy()
            got = ranks[0]["forward"][name]["y"].numpy()
            err = float(np.abs(got - want).max())
            rel = rel_l2(got, want)
            held = [ranks[r]["forward"][name] for r in (0, 1)]
            full = UNET_PARAMS if name == "unet" else FASTDDPM_PARAMS
            forward[name] = {"max_abs_err": err, "rel_l2": rel,
                             "params_by_rank": [h["params"] for h in held],
                             "bytes_by_rank": [h["bytes"] for h in held],
                             "params_unsharded": full}
            print(f"{name} column-parallel forward, model axis 2 over ranks "
                  f"0 and 1 ({BATCH} x {HW}^2, float32): vs the "
                  f"single-process forward on the card max |diff| "
                  f"{err:.6g} (|y| max {np.abs(want).max():.6g}), rel-L2 "
                  f"{rel:.6g} (bound {TP_REL_L2:g}); parameters a rank "
                  f"{[h['params'] for h in held]} of {full}, bytes a rank "
                  f"{[h['bytes'] for h in held]}")
            if not (np.isfinite(got).all() and got.shape == want.shape
                    and rel <= TP_REL_L2):
                raise AssertionError(f"{name} sharded forward rel-L2 {rel}")
            if not held[0]["params"] == held[1]["params"] < full:
                raise AssertionError(f"{name} parameters held {held}")
        flagged = [r for r in site_rows if r["over_bound"] > TP_SITE_FLAG]
        for r in site_rows:
            print(f"  sharded {r['model']}.{r['site']}: in {r['in']} -> "
                  f"out {r['out']}: {r['ms']:.4f} ms, float32 bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{r['over_bound']:.1f}x"
                  + (" FLAGGED" if r in flagged else ""))
        print(f"sharded convs over {TP_SITE_FLAG:g}x their float32 bound: "
              + (", ".join(f"{r['model']}.{r['site']} "
                           f"{r['over_bound']:.1f}x" for r in flagged)
                 or "none") + f" ({card})")
        results["forward"] = forward
        results["sites"] = site_rows

        # (b) the 2 x 2 step: the two model copies bit-equal, and equal
        # to the pair's step within phase 13's bounds
        t0 = time.perf_counter()
        steps = [r["step"]["2x2"] for r in ranks]
        if [s["rows"] for s in steps] != [TP_STEP_BATCH // 2] * TP_RANKS:
            raise AssertionError(
                f"2x2 rows a rank {[s['rows'] for s in steps]}")
        if [s["coords"] for s in steps] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
            raise AssertionError(f"2x2 coords {[s['coords'] for s in steps]}")
        copies = steps[0], steps[1]
        bit_equal = (len({s["loss"] for s in steps}) == 1 and all(
            torch.equal(copies[0][k][n], copies[1][k][n])
            for k in ("grads", "stats") for n in copies[0][k]))
        print(f"unet_combined step on the 2 x 2 mesh ({TP_RANKS} ranks, "
              f"{TP_STEP_BATCH // 2} rows a data rank): losses "
              f"{[s['loss'] for s in steps]}; the two model copies "
              f"bit-equal: {bit_equal}")
        if not bit_equal:
            raise AssertionError("the 2x2 mesh's model copies differ")
        pair = ranks[0]["step"]["pair"]

        def ref64():
            tr = SupervisedTrainer(ucfg, perceptual_fn=make_perceptual_fn(
                ucfg.loss.perceptual, dtype=torch.float64), device="cpu")
            tr.state.module.double()
            tr.train_step(tr.state, batch.double())
            return {n: p.grad.detach().double()
                    for n, p in tr.state.module.named_parameters()}

        # the witness: each data rank's own gradients before the all-reduce.
        # Past a process's first step the mesh changes no bit: the same rows
        # give the same local gradients on either mesh, on either rank pair
        witness = {}
        for what, (a, la), (b, lb) in (
                ("rows 0-1, rank 0: its first step (the warm-up) vs the "
                 "2x2 step", (0, "warm-up"), (0, "2x2")),
                ("rows 0-1, rank 0: the 2x2 step vs the pair's",
                 (0, "2x2"), (0, "pair")),
                ("rows 2-3: rank 2 in the 2x2 vs rank 1 in the pair",
                 (2, "2x2"), (1, "pair")),
                ("rows 0-1: rank 2 in the pair over ranks 2-3 vs rank 0 in "
                 "the pair", (2, "pair23"), (0, "pair")),
                ("rows 2-3: rank 3 in the pair over ranks 2-3 vs rank 1 in "
                 "the pair", (3, "pair23"), (1, "pair"))):
            witness[what] = grads_diff(ranks[a]["step"][la]["local"],
                                       ranks[b]["step"][lb]["local"])
            print(f"witness, own gradients before the all-reduce, {what}: "
                  f"{witness[what]}")
        witness["pair over ranks 2-3 vs over 0-1, reduced"] = grads_diff(
            ranks[2]["step"]["pair23"]["grads"], pair["grads"])
        witness["2x2 vs pair, reduced"] = grads_diff(steps[0]["grads"],
                                                     pair["grads"])
        for what in list(witness)[-2:]:
            print(f"witness, gradients after the all-reduce, {what}: "
                  f"{witness[what]}")
        caught = sorted({w for r in ranks for e in r["step"].values()
                         for w in e["warnings"]})
        print(f"nondeterminism warnings in the steps: {caught or 'none'}")
        unequal = [w for w in list(witness)[1:]
                   if witness[w]["equal"] != witness[w]["of"]]
        if unequal:
            raise AssertionError(f"the mesh changed the step's bits: "
                                 f"{unequal}")
        same = not unequal
        results["step"] = {**dp_step_check(
            "unet_combined", pair, steps[0], steps[0]["loss"], ref64,
            mine="the 2 x 2 mesh's step",
            theirs="the 2-rank pair's (phase 13's mesh)"),
            "copies_bit_equal": bit_equal, "pair_bit_equal": same,
            "witness": witness}
        print(f"2 x 2 step vs the pair's (phase 13's mesh): bit-equal: "
              f"{same}")
        walls["checks"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    results["walls"] = walls
    print(f"model-axis phase launches {launches} (no kernel is on this path)")
    print("model-axis wall (s): " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in walls.items())
          + f" ({card}; four ranks share one card: not a scaling number)")
    return launches, results


# phase 15: the JAX package's last public names in the port
RESIZE_SHAPE = (60, 512, 512)  # one volume of 512^2 slices -> 256^2
RESIZE_ATOL = 1e-5             # tests/test_torch_port_resize.py's bound
BF16_ULPS = 2 ** -6            # bf16: two ulps of the largest |y|


def names_phase(dev, card: str):
    """The JAX package's last public names on the card (see the module
    docstring, item 15).  Returns the results."""
    from mrisr_tpu_torch.config import PRESETS, ModelConfig
    from mrisr_tpu_torch.device import fp32_reference
    from mrisr_tpu_torch.losses.vgg import (convert_torch_vgg16,
                                            make_perceptual_fn)
    from mrisr_tpu_torch.models.blocks import (
        PixelShuffleUpConv, UpConv2x2, max_pool_3x3_s1, set_compute_dtype)
    from mrisr_tpu_torch.models.registry import create_model, param_count
    from mrisr_tpu_torch.ops.resize import (resize_bilinear,
                                            resize_bilinear_nhwc)

    results, walls = {"upconv": []}, {}
    t_phase = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(15)

    def timed(m, x, dy):
        def fwd():
            with torch.no_grad():
                m(x)

        def fwd_bwd():
            xg = x.detach().requires_grad_(True)
            m(xg).backward(dy)

        return cuda_ms(fwd, reps=10), cuda_ms(fwd_bwd, reps=10)

    # --- PixelShuffleUpConv against ConvTranspose2d on one state dict at
    # the UNet's four upconv sites, float32 (TF32 off) and bf16 compute
    def upconv_rows():
        for name, h, ci, co in upconv_sites(FEATURES):
            convt = UpConv2x2(ci, co).to(dev)
            shuffle = UpConv2x2(ci, co, impl="pixel_shuffle").to(dev)
            shuffle.load_state_dict(convt.state_dict())
            if not isinstance(shuffle, PixelShuffleUpConv):
                raise AssertionError("impl='pixel_shuffle' built "
                                     f"{type(shuffle).__name__}")
            x = torch.randn((BATCH, ci, h, h), generator=g).to(dev)
            dy = torch.randn((BATCH, co, 2 * h, 2 * h), generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                cd = None if dtype == torch.float32 else dtype
                for m in (convt, shuffle):
                    set_compute_dtype(m, cd)
                with torch.no_grad():
                    want, got = convt(x), shuffle(x)
                diff = float((got.float() - want.float()).abs().max())
                bound = (1e-5 if cd is None
                         else BF16_ULPS * float(want.float().abs().max()))
                row = {"site": name, "shape": [BATCH, ci, h, h], "co": co,
                       "dtype": str(dtype).split(".")[-1],
                       "max_abs_diff": diff, "bound": bound}
                if not diff <= bound:
                    raise AssertionError(f"pixel_shuffle vs convt {row}")
                for impl, m in (("convt", convt), ("pixel_shuffle", shuffle)):
                    row[f"{impl}_ms"], row[f"{impl}_fwd_bwd_ms"] = timed(
                        m, x, dy.to(dtype))
                results["upconv"].append(row)
                print(f"upconv {name} {row['dtype']:8s} x {tuple(x.shape)} "
                      f"-> {co}: pixel_shuffle vs convt max |diff| {diff:.3g}"
                      f" (bound {bound:.3g}); fwd ms convt "
                      f"{row['convt_ms']:.4f} pixel_shuffle "
                      f"{row['pixel_shuffle_ms']:.4f}; fwd+bwd ms convt "
                      f"{row['convt_fwd_bwd_ms']:.4f} pixel_shuffle "
                      f"{row['pixel_shuffle_fwd_bwd_ms']:.4f} ({card})")

    t0 = time.perf_counter()
    with fp32_reference():
        upconv_rows()
    walls["upconv"] = time.perf_counter() - t0

    # --- resize_bilinear(antialias) and resize_bilinear_nhwc: the card
    # against the same calls on the CPU, one volume 512^2 -> 256^2
    t0 = time.perf_counter()
    vol = torch.rand(RESIZE_SHAPE, generator=g)
    out_hw = (RESIZE_SHAPE[1] // 2, RESIZE_SHAPE[2] // 2)
    resize = {}
    for label, fn, x in (
            ("resize_bilinear", resize_bilinear, vol),
            ("resize_bilinear_nhwc", resize_bilinear_nhwc, vol[..., None])):
        for aa in (False, True):
            got = fn(x.to(dev), out_hw, antialias=aa).cpu()
            want = fn(x, out_hw, antialias=aa)
            diff = float((got - want).abs().max())
            resize[f"{label} antialias={aa}"] = diff
            if got.shape != want.shape or not diff <= RESIZE_ATOL:
                raise AssertionError(f"{label} antialias={aa}: card vs CPU "
                                     f"{tuple(got.shape)} max |diff| {diff}")
    if resize_bilinear(vol.to(dev), RESIZE_SHAPE[1:]).shape != vol.shape:
        raise AssertionError("resize_bilinear to the same size")
    print(f"resize {RESIZE_SHAPE} -> {out_hw}, card vs CPU max |diff|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in resize.items())
          + f" (bound {RESIZE_ATOL})")
    results["resize"] = resize

    # --- max_pool_3x3_s1 on the card against the CPU (exact), the DeepCNN
    # stem's map at batch 8
    x = torch.randn((BATCH, FEATURES, HW, HW), generator=g) - 3.0
    if not torch.equal(max_pool_3x3_s1(x.to(dev)).cpu(), max_pool_3x3_s1(x)):
        raise AssertionError("max_pool_3x3_s1: card and CPU differ")

    # --- param_count of every family at its preset's width (on the meta
    # device: no weights), the module's and its state dict's
    counts = {}
    for name, want in {"unet": UNET_PARAMS, **FAMILY_PARAMS}.items():
        cfg = PRESETS[name].model if name in PRESETS else ModelConfig(
            name=name)
        with torch.device("meta"):
            model = create_model(name, cfg)
        counts[name] = (param_count(model), param_count(model.state_dict()))
        if counts[name] != (want, want):
            raise AssertionError(f"param_count({name}) {counts[name]}, "
                                 f"want {want}")
    results["param_count"] = {k: v[0] for k, v in counts.items()}

    # --- convert_torch_vgg16 from a torchvision-keyed state dict on the
    # card; the perceptual loss from its npz on the card and on the CPU
    plan = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
            (10, 128, 256), (12, 256, 256), (14, 256, 256))
    sd = {}
    for ti, ci, co in plan:
        sd[f"features.{ti}.weight"] = (torch.randn(
            (co, ci, 3, 3), generator=g) / (9 * ci) ** 0.5).to(dev)
        sd[f"features.{ti}.bias"] = 0.05 * torch.randn(
            (co,), generator=g).to(dev)
    p, q = torch.randn((2, 2, 64, 64, 1), generator=g)
    with tempfile.TemporaryDirectory() as work:
        npz = os.path.join(work, "vgg16.npz")
        convert_torch_vgg16(sd, npz)
        with fp32_reference():
            on_card = float(make_perceptual_fn(npz)(p.to(dev), q.to(dev)))
        on_cpu = float(make_perceptual_fn(npz)(p, q))
    if not abs(on_card - on_cpu) <= 1e-5 * abs(on_cpu):
        raise AssertionError(f"VGG perceptual from the converted npz: card "
                             f"{on_card} CPU {on_cpu}")
    results["vgg_perceptual"] = {"card": on_card, "cpu": on_cpu}
    print(f"max_pool_3x3_s1 card == CPU; param_count {results['param_count']}"
          f"; VGG perceptual from convert_torch_vgg16's npz card {on_card:.7g}"
          f" CPU {on_cpu:.7g}")
    walls["resize, pool, counts, VGG"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    results["walls"] = walls
    print("names wall (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         walls.items()) + f" ({card})")
    return results


# phase 16: peaks at these batches, and the largest batch at which one
# float32 step fits, probed largest first.  What remat's step adds at its
# peak over what it started with (its activations, with cuDNN off) at the
# last batch must be at least REMAT_PEAK_FACTOR below plain's: with cuDNN's
# heuristic, one conv's workspace (dec2.conv.0, 256 -> 128 at 128^2: 22.18
# GB at batch 32, tools/remat_memory_probe.py) sits in both steps' peaks,
# and cuDNN takes it only because the memory is free
REMAT_MEM_BATCHES = (4, 32)
REMAT_PROBES = (512, 384, 256, 192, 128)
REMAT_PEAK_FACTOR = 1.5


def step_reference(cfg):
    """Phase 8's reference for a float32 unet_combined step at ``cfg``,
    for phase 16 run on its own: the first train batch of phase 8's store,
    the same step in float64 on the CPU (its module, gradients held) and
    each gradient's bound, max(GRAD_RTOL, GRAD_NOISE_FACTOR x the CPU
    float32 step's error)."""
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    with tempfile.TemporaryDirectory() as work:
        cli.main(["synth", work, "--patients", str(TRAIN_PATIENTS),
                  "--slices", str(TRAIN_SLICES), "--size", str(HW)])
        batch = next(iter(build_loader(VolumeStore.open(work), "train",
                                       cfg.data, device="cpu")))
    on_cpu = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
        cfg.loss.perceptual), device="cpu")
    on_ref = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
        cfg.loss.perceptual, dtype=torch.float64), device="cpu")
    on_ref.state.module.double()
    on_cpu.train_step(on_cpu.state, batch)
    on_ref.train_step(on_ref.state, batch.double())
    errs = grad_errors(on_cpu.state.module, on_ref.state.module)
    return {"batch": batch, "f64": on_ref.state.module,
            "bound": {n: max(GRAD_RTOL, GRAD_NOISE_FACTOR * e)
                      for n, e in errs.items()}}


def step_memory(trainer, batch: int, dev, g, cudnn: bool = True):
    """One train step of ``trainer`` on a random batch of ``batch``
    256^2 triplets: (torch.cuda.max_memory_allocated during it, the memory
    allocated before it), in GB; ``cudnn=False``: every conv PyTorch's
    own, so no cuDNN workspace is in the peak."""
    import gc

    x = torch.rand((batch, HW, HW, 3), generator=g, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        trainer.train_step(trainer.state, x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = prev
    return torch.cuda.max_memory_allocated() / 1e9, before / 1e9


def largest_batch(trainer, dev, g):
    """The largest batch of REMAT_PROBES (tried largest first) at which
    one train step completes, or None; and each probe's outcome.  Only
    torch.cuda.OutOfMemoryError counts as not fitting."""
    import gc

    tried = {}
    for batch in REMAT_PROBES:
        x = None
        try:
            x = torch.rand((batch, HW, HW, 3), generator=g, device=dev)
            trainer.train_step(trainer.state, x)
            torch.cuda.synchronize()
            tried[batch] = "fits"
        except torch.cuda.OutOfMemoryError:
            tried[batch] = "out of memory"
        finally:
            del x
            gc.collect()
            torch.cuda.empty_cache()
        if tried[batch] == "fits":
            return batch, tried
    return None, tried


def remat_phase(dev, card: str, step_ref=None):
    """Activation rematerialization of the full-width UNet (see the module
    docstring, item 16); ``step_ref``: phase 8's batch, float64 CPU module
    and gradient bounds (made here when None).  Returns the results."""
    import dataclasses

    import torch.nn.functional as F

    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    results, walls = {}, {}
    t_phase = time.perf_counter()
    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=TRAIN_BATCH, augment=False),
        model=dataclasses.replace(base.model, base_features=FEATURES))
    configs = {"plain": cfg, "remat": cfg.replace(
        model=dataclasses.replace(cfg.model, remat=True))}
    if not step_ref:
        t0 = time.perf_counter()
        step_ref = step_reference(cfg)
        walls["float64 reference"] = time.perf_counter() - t0
    batch = step_ref["batch"]
    xb = batch.to(dev)
    perceptual = make_perceptual_fn(cfg.loss.perceptual)

    # --- (a) the plain and the remat float32 step from one init and batch,
    # with cuDNN's deterministic algorithms, after a warm-up step (a
    # process's first call at a shape may take other bits from cuDNN than
    # its later ones)
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        warm = SupervisedTrainer(cfg, perceptual_fn=perceptual, device=dev)
        warm.train_step(warm.state, xb)
        del warm
        steps = {}
        for label, c in configs.items():
            tr = SupervisedTrainer(c, perceptual_fn=perceptual, device=dev)
            _, m = tr.train_step(tr.state, xb)
            steps[label] = (float(m["loss"]), tr.state.module)
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    (loss0, plain), (loss1, remat) = steps["plain"], steps["remat"]
    errs = grad_errors(remat, step_ref["f64"])
    bound = step_ref["bound"]
    over = [n for n, e in errs.items() if not e <= bound[n]]
    # remat against plain: each gradient's difference, a conv bias before
    # a training-mode BatchNorm's against its weight's gradient
    pg = {n: p.grad.double() for n, p in plain.named_parameters()}
    vs_plain = {}
    for n, p in remat.named_parameters():
        conv, _, leaf = n.rpartition(".")
        ref = pg[conv + ".weight" if leaf == "bias" and conv.endswith(
            (".conv.0", ".conv.3")) else n]
        vs_plain[n] = float((p.grad.double() - pg[n]).norm() / ref.norm())
    stats = dict(plain.named_buffers())
    stats_diff = max(float((b.double() - stats[n].double()).abs().max())
                     for n, b in remat.named_buffers() if "running" in n)
    tracked = {int(b) for n, b in remat.named_buffers()
               if n.endswith("num_batches_tracked")}
    worst = max(errs, key=errs.get)
    n_params = sum(p.numel() for p in remat.parameters())
    print(f"remat step vs plain step, float32 ({n_params} parameters, "
          f"batch {TRAIN_BATCH}, {HW}x{HW}): loss {loss1:.9f} remat, "
          f"{loss0:.9f} plain; remat gradients vs float64 CPU worst rel-L2 "
          f"{errs[worst]:.3g} ({worst}), {len(over)} past phase 8's "
          f"bounds; vs the plain step worst difference rel-L2 "
          f"{max(vs_plain.values()):.3g}; running stats max |diff| "
          f"{stats_diff:.3g}; num_batches_tracked {sorted(tracked)} ({card})")
    if loss1 != loss0:
        raise AssertionError(f"remat loss {loss1} != plain {loss0}")
    if over:
        raise AssertionError(f"remat gradients past phase 8's bounds: "
                             f"{[(n, errs[n], bound[n]) for n in over]}")
    if stats_diff != 0.0:
        raise AssertionError(f"remat running stats differ by {stats_diff}")
    if tracked != {1}:
        raise AssertionError(f"num_batches_tracked {tracked} after a step")
    results["float32"] = {"loss": loss1, "grad_rel_l2_f64_max": errs[worst],
                          "grad_rel_l2_vs_plain_max": max(vs_plain.values()),
                          "stats_max_diff": stats_diff}
    del steps, plain, remat
    walls["float32 pair"] = time.perf_counter() - t0

    # --- (b) the pair in bf16 compute at SMALL_HW, SMALL_BATCH (phase 10)
    t0 = time.perf_counter()
    small = F.avg_pool2d(batch[:SMALL_BATCH].permute(0, 3, 1, 2),
                         HW // SMALL_HW).permute(0, 2, 3, 1).contiguous()
    small_cfgs = {label: c.replace(data=dataclasses.replace(
        c.data, image_size=(SMALL_HW, SMALL_HW), batch_size=SMALL_BATCH))
        for label, c in configs.items()}
    results["bf16_vs_f64"] = bf16_step_check(
        "unet_combined", small_cfgs["remat"], small, dev, card)
    pair = {}
    for label, c in small_cfgs.items():
        tr, _ = make_trainer("unet_combined", c.replace(
            train=dataclasses.replace(c.train, compute_dtype="bfloat16")),
            dev)
        _, m = tr.train_step(tr.state, small.to(dev))
        module = tr.state.module
        pair[label] = (float(m["loss"]), torch.cat([
            dict(module.named_parameters())[n].grad.double().ravel()
            for n in weights_and_norms(module)]))
    loss_rel = abs(pair["remat"][0] - pair["plain"][0]) / abs(pair["plain"][0])
    grad_rel_l2 = float((pair["remat"][1] - pair["plain"][1]).norm()
                        / pair["plain"][1].norm())
    print(f"remat vs plain bf16 step on the card (batch {SMALL_BATCH}, "
          f"{SMALL_HW}x{SMALL_HW}): loss rel {loss_rel:.3g} (bound "
          f"{BF16_LOSS_RTOL:g}), weights' and norms' gradients rel-L2 "
          f"{grad_rel_l2:.3g} (bound {BF16_GRAD_BUDGET:g}) ({card})")
    if not (loss_rel <= BF16_LOSS_RTOL and grad_rel_l2 <= BF16_GRAD_BUDGET):
        raise AssertionError(f"remat vs plain bf16: loss rel {loss_rel}, "
                             f"gradients rel-L2 {grad_rel_l2}")
    results["bf16_vs_plain"] = {"loss_rel": loss_rel,
                                "grad_rel_l2": grad_rel_l2}
    del pair
    walls["bf16 pair"] = time.perf_counter() - t0

    # --- (c) peak memory and step time at batch 4 and 32, and the largest
    # batch that fits; one trainer on the card at a time
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(16)
    memory = {}
    for label, c in configs.items():
        tr = SupervisedTrainer(c, perceptual_fn=perceptual, device=dev)
        tr.train_step(tr.state, xb)  # Adam's moments allocated
        row = {}
        for b in REMAT_MEM_BATCHES:
            peak, before = step_memory(tr, b, dev, g)
            own, own_before = step_memory(tr, b, dev, g, cudnn=False)
            x = torch.rand((b, HW, HW, 3), generator=g, device=dev)
            ms = cuda_ms(lambda: tr.train_step(tr.state, x), reps=3,
                         warmup=1)
            del x
            row[b] = {"peak_gb": peak, "before_gb": before,
                      "peak_gb_cudnn_off": own,
                      "before_gb_cudnn_off": own_before, "step_ms": ms}
            print(f"{label} float32 step at batch {b}: peak {peak:.3f} GB "
                  f"allocated, {before:.3f} GB before the step; with cuDNN "
                  f"off {own:.3f} GB, {own_before:.3f} GB before; "
                  f"{ms:.3f} ms ({card})")
        row["largest_batch"], row["probes"] = largest_batch(tr, dev, g)
        print(f"{label}: largest batch of {list(REMAT_PROBES)} at which one "
              f"float32 step fits: {row['largest_batch']} ({row['probes']})"
              f" ({card})")
        memory[label] = row
        del tr
        torch.cuda.empty_cache()
    results["memory"] = memory
    b32 = REMAT_MEM_BATCHES[-1]
    # what the step itself adds at its peak, over what it started with
    step_gb = {label: {key: r[b32][f"peak_gb{key}"] - r[b32][f"before_gb{key}"]
                       for key in ("", "_cudnn_off")}
               for label, r in memory.items()}
    ratios = {key or "_cudnn_on": step_gb["plain"][key] / step_gb["remat"][key]
              for key in ("", "_cudnn_off")}
    peak_ratio = ratios["_cudnn_off"]
    slowdown = {b: memory["remat"][b]["step_ms"]
                / memory["plain"][b]["step_ms"] for b in REMAT_MEM_BATCHES}
    print(f"remat: the step's own peak (peak - before) at batch {b32} "
          f"{peak_ratio:.3f}x below plain's with cuDNN off (bound "
          f"{REMAT_PEAK_FACTOR}x), {ratios['_cudnn_on']:.3f}x with cuDNN's "
          f"heuristic; step time "
          + ", ".join(f"{v:.3f}x plain's at batch {b}"
                      for b, v in slowdown.items()) + f" ({card})")
    ceilings = [memory[k]["largest_batch"] or 0 for k in ("plain", "remat")]
    if not peak_ratio >= REMAT_PEAK_FACTOR:
        raise AssertionError(f"remat's own peak at batch {b32} (cuDNN "
                             f"off) only {peak_ratio}x below plain's")
    if not ceilings[1] >= ceilings[0]:
        raise AssertionError(f"remat's largest batch {ceilings[1]} below "
                             f"plain's {ceilings[0]}")
    results.update(step_gb_b32=step_gb, peak_ratios_b32=ratios,
                   slowdown=slowdown)
    walls["memory and time"] = time.perf_counter() - t0

    # --- (d) phase 13's rank pair: the plain and the remat step
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks = run_dp_ranks({"device": str(dev), "batch": batch,
                              "same_bits": True, "configs": {
                                  "unet_combined": json.loads(
                                      configs["plain"].to_json()),
                                  "unet_combined remat": json.loads(
                                      configs["remat"].to_json())}}, work)
    for case in ("unet_combined", "unet_combined remat"):
        losses = [r[case]["loss"] for r in ranks]
        if losses[0] != losses[1]:
            raise AssertionError(f"{case}: the ranks report {losses}")
    plain_dp = ranks[0]["unet_combined"]
    remat_dp = ranks[0]["unet_combined remat"]
    results["dp"] = dp_step_check(
        "unet_combined remat", plain_dp, remat_dp, remat_dp["loss"],
        lambda: {n: p.grad.detach().double()
                 for n, p in step_ref["f64"].named_parameters()},
        mine=f"{DP_RANKS}-rank remat step",
        theirs=f"the {DP_RANKS}-rank plain step")
    unequal = [n for n, t in plain_dp["stats"].items()
               if not torch.equal(t, remat_dp["stats"][n])]
    print(f"{DP_RANKS}-rank remat vs plain running statistics: "
          f"{len(unequal)} of {len(plain_dp['stats'])} tensors differ "
          f"({card})")
    if unequal:
        raise AssertionError(f"2-rank remat running statistics differ: "
                             f"{unequal}")
    walls["2-rank pair (spawn included)"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    results["walls"] = walls
    print("remat wall (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         walls.items()) + f" ({card})")
    return results


def ddpm_phase(dev, card: str):
    """The DDPM UNet at the fastddpm_pmub preset's widths (docstring, item
    17): one int8_deep denoiser call at the serving batch, counted from 0,
    then K3 against its plain version at every distinct site of that call;
    then ADM's call and shapes (:func:`adm_check`), the quantizer's and
    E's sites (:func:`quant_check`, :func:`bias_check`) and DiT's call and
    new kernel forms (:func:`dit_check`), and kernel A's 1x1 sites of all
    four nets on both tensor-core forms (:func:`gemm_check`).  Returns
    (launches of the call, results)."""
    from collections import Counter

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.device import sm_count
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.groupnorm import (
        groupnorm_silu, groupnorm_silu_plain, plan)
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm, deep_sites, int8_forward, quantize_fastddpm)

    t_phase = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(17)
        model = DDPMUNet(base_features=DDPM_CH)
    params = fastddpm_flax_params(model.to(dev))
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    g = torch.Generator(device=dev).manual_seed(1717)
    cond = torch.randn((CHECK_BATCH, HW, HW, 2), generator=g, device=dev)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib, only=deep_sites(params))
    fwd = int8_forward(q, device=dev)
    sites, gn8, quant_sites, q8 = [], fwd._gn8, [], fwd._q8
    bias_sites, e = [], fwd._bias

    def record(x, gamma, beta, **kw):
        # (H, C, groups, silu, int8, eps, shifted)
        sites.append((x.shape[1], x.shape[3], kw["num_groups"], kw["silu"],
                      kw.get("quant_scale") is not None, kw["eps"],
                      kw.get("shift") is not None))
        return gn8(x, gamma, beta, **kw)

    def record_quant(x, a):  # (H, C) of the quantizer's input
        quant_sites.append((x.shape[1], x.shape[3]))
        return q8(x, a)

    def record_bias(y, b, r=None, rb=None):  # (H, C, mode) of E's call
        bias_sites.append((y.shape[1], y.shape[3], bias_mode(r, rb)))
        return e(y, b, r, rb)

    fwd._gn8, fwd._q8, fwd._bias = record, record_quant, record_bias
    a_1x1 = Counter()
    conv8 = record_1x1(fwd, a_1x1)
    x = torch.randn((DDPM_BATCH, HW, HW, 3), generator=g, device=dev)
    t = torch.full((DDPM_BATCH,), int(sched.timesteps[-1]), device=dev)
    reset_counts(conv2d_int8, upconv2x2_int8)
    got = fwd(x, t)
    torch.cuda.synchronize()
    launches = k3_counts(conv2d_int8, upconv2x2_int8)
    counted = (launches["groupnorm_silu"], launches["groupnorm_silu/shift"],
               launches["groupnorm_silu/scale_shift"], launches["conv_int8"],
               launches["upconv_int8"], len(sites),
               launches["quantize_int8"], len(quant_sites),
               launches["bias_residual"], launches["bias_residual/residual"],
               len(bias_sites))
    want = (DDPM_K3, DDPM_SHIFTED, 0, DDPM_A, 0, DDPM_K3, DDPM_QUANT,
            DDPM_QUANT, *DDPM_E, DDPM_E[0])
    if counted != want:
        raise AssertionError(f"DDPM int8_deep call: K3 launches, with a "
                             f"shift, with a scale-shift, A, B launches, K3 "
                             f"sites, quantizer launches and sites, E "
                             f"launches, with a residual, E sites "
                             f"{counted}, want {want}")
    if tuple(got.shape) != (DDPM_BATCH, HW, HW, 1) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"DDPM int8_deep call: {tuple(got.shape)}, "
                             "or not finite")
    fwd._gn8, fwd._q8, fwd._bias, fwd._conv8 = gn8, q8, e, conv8
    if not torch.equal(fwd(x, t), got):
        raise AssertionError("DDPM int8_deep call: two calls differ")
    call_ms = cuda_ms(lambda: fwd(x, t), reps=3, warmup=1)
    del got, x, fwd
    print(f"DDPM int8_deep call, batch {DDPM_BATCH}: {counted[0]} K3 "
          f"({counted[1]} with a shift), {counted[3]} A, {counted[6]} "
          f"quantizer and {counted[8]} E launches ({counted[9]} with a "
          f"residual), the same bits twice, {call_ms:.2f} ms ({card})")

    sms, rows = sm_count(dev), []
    for (h, c, groups, silu, int8, eps, shifted), n in sorted(
            Counter(sites).items()):
        name = (f"{h}^2 C {c} groups of {c // groups} "
                f"{'int8' if int8 else 'bf16'}{'' if silu else ' no SiLU'}"
                f"{' shift' if shifted else ''}")
        gn = dict(num_groups=groups, eps=eps, silu=silu)
        gamma, beta = 1 + 0.5 * torch.randn(c, generator=g, device=dev), (
            0.2 * torch.randn(c, generator=g, device=dev))
        xin = (3 * torch.randn((DDPM_BATCH, h, h, c), generator=g, device=dev)
               + 0.5).to(torch.bfloat16)
        if shifted:  # a ResBlock's norm2: its time projection as the shift
            gn["shift"] = torch.randn((DDPM_BATCH, c), generator=g,
                                      device=dev)
        ref = groupnorm_silu_plain(xin, gamma, beta, out_dtype=torch.float32,
                                   **gn)
        row = {"kernel": "groupnorm_silu ddpm", "site": name, "H": h, "C": c,
               "group": c // groups, "silu": silu, "int8": int8,
               "sites": n, "batch": DDPM_BATCH}
        if int8:
            scale = (ref.abs().amax() / 127).reshape(1)

            def run():
                return groupnorm_silu(xin, gamma, beta, quant_scale=scale,
                                      **gn)
            codes = run()
            torch.cuda.synchronize()
            want = groupnorm_silu_plain(xin, gamma, beta, quant_scale=scale,
                                        **gn)
            diff = (codes.int() - want.int()).abs()
            worst, off1 = int(diff.max()), float((diff == 1).float().mean())
            if worst > (0 if shifted else 1) or off1 >= 1e-3:
                raise AssertionError(f"K3 DDPM {name}: codes differ: max "
                                     f"{worst}, {off1:.4%} off by 1")
            if not torch.equal(run(), codes):
                raise AssertionError(f"K3 DDPM {name}: two launches differ")
            row.update(max_abs_err=float(worst), off_by_one=off1)
            del codes, want, diff
        else:
            def run():
                return groupnorm_silu(xin, gamma, beta, **gn)
        # the bf16 mode at every site (the float sites' own output): one
        # bf16 rounding step, as phase 6 holds the notebook net's sites
        y16 = groupnorm_silu(xin, gamma, beta, **gn)
        err = (y16.float() - ref).abs()
        tol = torch.clamp_min(ref.abs() * 2.0 ** -8, GN_BF16_ATOL)
        if bool((err > tol).any()):
            raise AssertionError(f"K3 DDPM {name}: bf16 output off by "
                                 f"{float(err.max())} (worst "
                                 f"{float((err / tol).max()):.3f} of its "
                                 "tolerance)")
        if not int8 and not torch.equal(run(), y16):
            raise AssertionError(f"K3 DDPM {name}: two launches differ")
        p = plan(DDPM_BATCH, h * h, c, xin.element_size(), sms)
        row.update(bf16_err=float(err.max()),
                   ms=cuda_ms(run, reps=10, warmup=2),
                   form="one-read" if p.one_read else "two-read",
                   samples_a_pass=p.spp, passes=p.passes)
        if shifted:  # the same launch without the shift: what it adds
            gn.pop("shift")
            row["no_shift_ms"] = cuda_ms(run, reps=10, warmup=2)
        rows.append(row)
        del xin, ref, y16, err, tol
        print(f"K3 DDPM {name:42s} x{n:2d}: {row['form']} "
              f"{p.spp} a pass x {p.passes}, int8 max "
              f"{row.get('max_abs_err', '-')}, bf16 err "
              f"{row['bf16_err']:.3g}, {row['ms']:.4f} ms"
              + (f" ({row['no_shift_ms']:.4f} without the shift)"
                 if shifted else ""))
    k3_ms = sum(r["ms"] * r["sites"] for r in rows)
    shifted = [r for r in rows if "no_shift_ms" in r]
    shift_ms = [sum(r[k] * r["sites"] for r in shifted)
                for k in ("ms", "no_shift_ms")]
    print(f"K3 DDPM: {len(rows)} distinct (shape, shift) cover {len(sites)} "
          f"sites (groups of {sorted({r['group'] for r in rows})}); "
          f"{k3_ms:.3f} ms a call at batch {DDPM_BATCH}, its "
          f"{sum(r['sites'] for r in shifted)} shifted sites {shift_ms[0]:.3f} "
          f"ms ({shift_ms[1]:.3f} without the shift) ({card})")
    del model, params, calib, q
    adm = adm_check(dev, g, sms, card)
    quant_rows = quant_check(dev, g, Counter(quant_sites), card,
                             adm.pop("quant_sites"))
    bias_rows = bias_check(dev, g, Counter(bias_sites), card)
    dit_result = dit_check(dev, g, card)
    gemm_rows = gemm_check(dev, g, card, {
        "dit": dit_result.pop("a_1x1"), "adm": adm.pop("a_1x1"),
        "ddpm": a_1x1, "notebook": notebook_1x1(dev, g)})
    return launches, {"call_ms": call_ms, "k3_ms": k3_ms, "sites": rows,
                      "shifted_ms": shift_ms, "quant_sites": quant_rows,
                      "bias_sites": bias_rows, "adm": adm, "dit": dit_result,
                      "gemm_sites": gemm_rows,
                      "wall_s": time.perf_counter() - t_phase}


def k3_counts(conv, up):
    """:func:`launch_counts` with K3's: all, with a shift, with a
    scale-shift."""
    from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu

    return {"groupnorm_silu": groupnorm_silu.launches,
            "groupnorm_silu/shift": groupnorm_silu.launches_shift,
            "groupnorm_silu/scale_shift": groupnorm_silu.launches_scale_shift,
            **launch_counts(conv, up)}


def adm_check(dev, g, sms, card: str):
    """ADM's UNet (``models/adm_unet.py``, the fastddpm_adm preset's ch 256,
    256^2), seeded, calibrated on one batch of 2 over the 10-step sampler
    and quantized int8_deep: one denoiser call at batch 2, counted from 0
    (ADM_K3 K3 launches, ADM_SCALE_SHIFT of them scale-shift, ADM_A A, no
    B, ADM_QUANT quantizer launches, ADM_ATTN attention cores on the fused
    path, ADM_E kernel E launches, all and with a residual), the same bits on a second call and within ADM_PLAIN_REL of the
    same tables through the kernels' plain versions.  Then K3 at batch 32
    at each distinct shape of that call that the DDPM UNet does not have:
    the scale-shift norms (their ``(32, 2 C)`` rows) and the groups over
    32 channels (1536 in groups of 48, 2048 in 64): int8 codes equal to
    the plain version's, bf16 within one rounding step, the same bits
    twice, one launch counted a call, its time against its bound (the
    rows' 8 n C bytes counted).  Returns the call's launches, the K3 rows,
    the quantizer's (H, C) sites (a Counter) for :func:`quant_check` and
    kernel A's 1x1 sites (:func:`record_1x1`) for :func:`gemm_check`."""
    from collections import Counter

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.adm_unet import ADMUNet, qkv_attention
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
    from mrisr_tpu_torch.ops.groupnorm import (
        groupnorm_silu, groupnorm_silu_plain, plan)
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm, deep_sites, int8_forward, quantize_fastddpm)

    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]), \
            torch.device(dev):
        torch.manual_seed(23)
        params = fastddpm_flax_params(ADMUNet(base_features=ADM_CH))
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    cond = torch.randn((CHECK_BATCH, HW, HW, 2), generator=g, device=dev)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib, only=deep_sites(params))
    del params, calib
    fwd = int8_forward(q, device=dev)
    sites, gn8, quant_sites, q8 = [], fwd._gn8, Counter(), fwd._q8

    def record(x, gamma, beta, **kw):
        # (H, C, groups, silu, int8, eps, scale-shift)
        sites.append((x.shape[1], x.shape[3], kw["num_groups"], kw["silu"],
                      kw.get("quant_scale") is not None, kw["eps"],
                      kw.get("scale_shift") is not None))
        return gn8(x, gamma, beta, **kw)

    def record_quant(x, a):
        quant_sites[(x.shape[1], x.shape[3])] += 1
        return q8(x, a)

    fwd._gn8, fwd._q8 = record, record_quant
    a_1x1 = Counter()
    conv8 = record_1x1(fwd, a_1x1)
    x = torch.randn((CHECK_BATCH, HW, HW, 3), generator=g, device=dev)
    t = torch.full((CHECK_BATCH,), int(sched.timesteps[-1]), device=dev)
    reset_counts(conv2d_int8, upconv2x2_int8)
    attn = (qkv_attention.calls_fused, qkv_attention.calls_float)
    got = fwd(x, t)
    torch.cuda.synchronize()
    launches = k3_counts(conv2d_int8, upconv2x2_int8)
    counted = (launches["groupnorm_silu"], launches["groupnorm_silu/shift"],
               launches["groupnorm_silu/scale_shift"], launches["conv_int8"],
               launches["upconv_int8"], len(sites),
               launches["quantize_int8"], sum(quant_sites.values()),
               qkv_attention.calls_fused - attn[0],
               qkv_attention.calls_float - attn[1],
               launches["bias_residual"], launches["bias_residual/residual"])
    want = (ADM_K3, 0, ADM_SCALE_SHIFT, ADM_A, 0, ADM_K3, ADM_QUANT,
            ADM_QUANT, ADM_ATTN, 0, *ADM_E)
    if counted != want:
        raise AssertionError(f"ADM int8_deep call: K3 launches, with a "
                             f"shift, with a scale-shift, A, B launches, K3 "
                             f"sites, quantizer launches and sites, fused "
                             f"and float attention cores, E launches and "
                             f"those with a residual {counted}, want "
                             f"{want}")
    fwd._gn8, fwd._q8, fwd._conv8 = gn8, q8, conv8
    if tuple(got.shape) != (CHECK_BATCH, HW, HW, 2) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"ADM int8_deep call: {tuple(got.shape)}, or "
                             "not finite")
    if not torch.equal(fwd(x, t), got):
        raise AssertionError("ADM int8_deep call: two calls differ")
    plain = int8_forward(q, device=dev, plain=True)(x, t)
    rel = float((got - plain).norm() / plain.norm())
    if rel >= ADM_PLAIN_REL:
        raise AssertionError(f"ADM int8_deep call: rel L2 {rel:.4g} from the "
                             "plain versions' call")
    del fwd, q, got, plain, x
    call_s = time.perf_counter() - t0
    print(f"ADM int8_deep call, batch {CHECK_BATCH}: {counted[0]} K3 "
          f"({counted[2]} scale-shift), {counted[3]} A, {counted[6]} "
          f"quantizer and {counted[10]} E launches ({counted[11]} with a "
          f"residual), {counted[8]} fused attention cores, the "
          f"same bits twice, rel L2 {rel:.4g} from the plain versions' "
          f"({call_s:.1f} s with calibration; {card})")

    scrub = torch.empty(16 * 2 ** 20, device=dev)
    rows = []
    for (h, c, groups, silu, int8, eps, post), n in sorted(
            Counter(sites).items()):
        if not post and c // groups <= 32:
            continue  # the DDPM UNet's shapes: checked above
        name = (f"{h}^2 C {c} groups of {c // groups} "
                f"{'int8' if int8 else 'bf16'}"
                f"{' scale-shift' if post else ''}")
        gn = dict(num_groups=groups, eps=eps, silu=silu)
        gamma, beta = 1 + 0.5 * torch.randn(c, generator=g, device=dev), (
            0.2 * torch.randn(c, generator=g, device=dev))
        xin = (3 * torch.randn((DDPM_BATCH, h, h, c), generator=g, device=dev)
               + 0.5).to(torch.bfloat16)
        if post:  # a ResBlock's (scale, shift) row, as the forward hands it
            gn["scale_shift"] = (0.5 * torch.randn(
                (DDPM_BATCH, 2 * c), generator=g, device=dev)).to(
                    torch.bfloat16)
        ref = groupnorm_silu_plain(xin, gamma, beta, out_dtype=torch.float32,
                                   **gn)
        if int8:
            gn["quant_scale"] = (ref.abs().amax() / 127).reshape(1)
            want = groupnorm_silu_plain(xin, gamma, beta, **gn)
        before = (groupnorm_silu.launches, groupnorm_silu.launches_scale_shift)
        out = groupnorm_silu(xin, gamma, beta, **gn)
        torch.cuda.synchronize()
        moved = (groupnorm_silu.launches - before[0],
                 groupnorm_silu.launches_scale_shift - before[1])
        if moved != (1, int(post)):
            raise AssertionError(f"K3 ADM {name}: launches counted, with a "
                                 f"scale-shift: {moved}")
        if int8:
            check_exact(out, want, groupnorm_silu(xin, gamma, beta, **gn),
                        f"K3 ADM {name}")
            del want
            y16 = groupnorm_silu(xin, gamma, beta,
                                 **{k: v for k, v in gn.items()
                                    if k != "quant_scale"})
        else:
            y16 = out
            if not torch.equal(groupnorm_silu(xin, gamma, beta, **gn), out):
                raise AssertionError(f"K3 ADM {name}: two launches differ")
        # the bf16 mode at every shape: one bf16 rounding step
        err = (y16.float() - ref).abs()
        tol = torch.clamp_min(ref.abs() * 2.0 ** -8, GN_BF16_ATOL)
        if bool((err > tol).any()):
            raise AssertionError(f"K3 ADM {name}: bf16 output off by "
                                 f"{float(err.max())} (worst "
                                 f"{float((err / tol).max()):.3f} of its "
                                 "tolerance)")
        elems = DDPM_BATCH * h * h * c
        ops = (GN_OPS_PER_ELEM - (0 if int8 else 3)) * elems
        t_ops = ops / PEAK_FP32_OPS * 1e3
        nbytes = ((3 if int8 else 4) * elems + 8 * c + 4
                  + 8 * DDPM_BATCH * c * post)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        p = plan(DDPM_BATCH, h * h, c, xin.element_size(), sms)
        ms = cuda_ms(lambda: groupnorm_silu(xin, gamma, beta, **gn), reps=10,
                     flush=scrub.zero_)
        row = {"kernel": "groupnorm_silu adm", "site": name, "H": h, "C": c,
               "group": c // groups, "silu": silu, "int8": int8,
               "scale_shift": post, "sites": n, "batch": DDPM_BATCH,
               "max_abs_err": 0.0, "bf16_err": float(err.max()), "ms": ms,
               "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
               "ops_ms": t_ops, "bytes_ms": t_bytes,
               "pct_of_bound": 100.0 * max(t_ops, t_bytes) / ms,
               "form": "one-read" if p.one_read else "two-read",
               "samples_a_pass": p.spp, "passes": p.passes}
        rows.append(row)
        del xin, ref, y16, out, err, tol
        print(f"K3 ADM {name:44s} x{n:2d}: {row['form']} {p.spp} a pass x "
              f"{p.passes}, int8 {'equal' if int8 else '-'}, bf16 err "
              f"{row['bf16_err']:.3g}, {ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ({row['pct_of_bound']:.1f} %)")
    print(f"K3 ADM: {len(rows)} shapes ({sum(r['sites'] for r in rows)} of "
          f"{len(sites)} sites) checked at batch {DDPM_BATCH}, "
          f"{sum(r['ms'] * r['sites'] for r in rows):.3f} ms for their "
          f"sites, bound {sum(r['bound_ms'] * r['sites'] for r in rows):.3f} "
          f"ms ({card})")
    return {"launches": launches, "rel_to_plain": rel, "sites": rows,
            "quant_sites": quant_sites, "a_1x1": a_1x1,
            "wall_s": time.perf_counter() - t0}


def dit_check(dev, g, card: str):
    """DiT-XL/8 (``models/dit.py``, the fastddpm_dit preset's widths,
    256^2: 1024 tokens of 1152 channels), seeded with torch's default init
    (the adaLN linears and the final layer non-zero), calibrated on one
    batch of 2 over the 10-step sampler and quantized int8_deep: one
    denoiser call at batch 2, counted from 0 (DIT_A A, DIT_GELU of them in
    the GELU form, DIT_L L, DIT_L_CODES of them emitting codes, DIT_QUANT
    quantizer launches, DIT_GATE gated E, DIT_ATTN attention cores on the
    fused path and none on the float one), the same bits on a second call
    and within DIT_PLAIN_REL of the same tables through the kernels' plain
    versions.  Then the three new forms at batch 32 at DiT's shapes, each
    one launch counted: L (codes, as before ``qkv`` and ``fc1``, and bf16,
    as before the final linear) the plain version's bits, bf16 also within
    one rounding of the float64 formula; A's GELU form at ``fc1`` (1152 ->
    4608) within one code of its plain version's, fewer than 1e-4 of the
    codes apart; E's gated form the plain version's bits, in place.  Each
    the same bits twice, its time (the L2 flushed before each launch)
    against its bound and the plain version's.  Returns the call's
    launches, the rows and kernel A's 1x1 sites (:func:`record_1x1`)."""
    from collections import Counter

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models import dit
    from mrisr_tpu_torch.models.adm_unet import qkv_attention
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.ops.bias_residual import (
        bias_residual, gated_residual, gated_residual_plain)
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv2d_int8_plain, pack_conv)
    from mrisr_tpu_torch.ops.layernorm import (
        layernorm_modulate, layernorm_modulate_plain)
    from mrisr_tpu_torch.ops.upconv import upconv2x2_int8
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm, deep_sites, int8_forward, quantize_fastddpm)

    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]), \
            torch.device(dev):
        torch.manual_seed(25)
        params = fastddpm_flax_params(dit.DiT())
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    cond = torch.randn((CHECK_BATCH, HW, HW, 2), generator=g, device=dev)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib, only=deep_sites(params))
    del params, calib
    fwd = int8_forward(q, device=dev)
    a_1x1 = Counter()
    conv8 = record_1x1(fwd, a_1x1)
    x = torch.randn((CHECK_BATCH, HW, HW, 3), generator=g, device=dev)
    t = torch.full((CHECK_BATCH,), int(sched.timesteps[-1]), device=dev)
    reset_counts(conv2d_int8, upconv2x2_int8)
    attn = (qkv_attention.calls_fused, qkv_attention.calls_float)
    got = fwd(x, t)
    torch.cuda.synchronize()
    fwd._conv8 = conv8
    launches = launch_counts(conv2d_int8, upconv2x2_int8)
    counted = (launches["conv_int8"], launches["conv_int8/gelu"],
               launches["conv_int8/gemm"],
               launches["layernorm_modulate"],
               launches["layernorm_modulate/codes"],
               launches["quantize_int8"], launches["bias_residual"],
               launches["bias_residual/gate"],
               qkv_attention.calls_fused - attn[0],
               qkv_attention.calls_float - attn[1])
    want = (DIT_A, DIT_GELU, DIT_A, DIT_L, DIT_L_CODES, DIT_QUANT, DIT_GATE,
            DIT_GATE, DIT_ATTN, 0)
    if counted != want:
        raise AssertionError(f"DiT int8_deep call: A launches, in the GELU "
                             f"form, in the GEMM form, L launches, emitting "
                             f"codes, quantizer "
                             f"launches, E launches, gated, fused and float "
                             f"attention cores {counted}, want {want}")
    if tuple(got.shape) != (CHECK_BATCH, HW, HW, 2) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"DiT int8_deep call: {tuple(got.shape)}, or "
                             "not finite")
    if not torch.equal(fwd(x, t), got):
        raise AssertionError("DiT int8_deep call: two calls differ")
    plain = int8_forward(q, device=dev, plain=True)(x, t)
    rel = float((got - plain).norm() / plain.norm())
    if rel >= DIT_PLAIN_REL:
        raise AssertionError(f"DiT int8_deep call: rel L2 {rel:.4g} from the "
                             "plain versions' call")
    del fwd, q, got, plain, x
    print(f"DiT int8_deep call, batch {CHECK_BATCH}: {counted[0]} A "
          f"({counted[1]} GELU, {counted[2]} GEMM form), {counted[3]} L "
          f"({counted[4]} codes), {counted[5]} quantizer and {counted[7]} "
          f"gated E launches, {counted[8]} fused attention cores, the same "
          f"bits twice, rel L2 "
          f"{rel:.4g} from the plain versions' ({time.perf_counter() - t0:.1f}"
          f" s with calibration; {card})")

    n, c, grid = DDPM_BATCH, dit.HIDDEN, HW // dit.PATCH
    m = dit.MLP_RATIO * c
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    mods = 0.5 * torch.randn((n, 6 * c), generator=g, device=dev)
    rows = []

    def one_launch(counter, key, fn):
        before = (counter.launches, getattr(counter, key))
        out = fn()
        torch.cuda.synchronize()
        if (counter.launches - before[0],
                getattr(counter, key) - before[1]) != (1, 1):
            raise AssertionError(f"{counter.__name__} {key}: not one launch "
                                 "counted")
        return out

    def timed(row, run, plain_run, ops, nbytes, peak_ops):
        t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
        row.update(ops=ops, bytes=nbytes, ops_ms=t_ops, bytes_ms=t_bytes,
                   bound_ms=max(t_ops, t_bytes), library_ms=None,
                   ms=cuda_ms(run, reps=10, flush=scrub.zero_),
                   plain_ms=cuda_ms(plain_run, reps=3, flush=scrub.zero_))
        row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"{row['kernel']} DiT {row['site']:34s} x{row['dit_sites']:2d}"
              f": {row['check']}, {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ({row['pct_of_bound']:.1f} %), plain "
              f"{row['plain_ms']:.3f} ms")

    # L: a block's LayerNorm and modulation, its (shift, scale) a strided
    # view of the six adaLN rows
    xb = (2 * torch.randn((n, grid, grid, c), generator=g, device=dev)
          + 0.3).to(torch.bfloat16)
    ss = mods[:, 3 * c:5 * c]
    y16 = layernorm_modulate_plain(xb, ss, eps=dit.LN_EPS)
    a = (y16.float().abs().amax() / 127.0).reshape(1)
    for codes in (True, False):
        kw = {"quant_scale": a} if codes else {}
        site = (f"{n} x {grid}^2 x {c} -> "
                f"{'codes' if codes else 'bf16'}")
        out = one_launch(layernorm_modulate,
                         "launches_codes" if codes else "launches",
                         lambda: layernorm_modulate(xb, ss, eps=dit.LN_EPS,
                                                    **kw))
        want = layernorm_modulate_plain(xb, ss, eps=dit.LN_EPS, **kw)
        again = layernorm_modulate(xb, ss, eps=dit.LN_EPS, **kw)
        if codes:
            check_exact(out, want, again, f"L DiT {site}")
        else:
            bits = [v.view(torch.int16) for v in (out, want, again)]
            if not (torch.equal(bits[0], bits[1])
                    and torch.equal(bits[2], bits[0])):
                raise AssertionError(f"L DiT {site}: not the plain "
                                     "version's bits, or two launches "
                                     "differ")
            xd = xb.double()
            exact = ((xd - xd.mean(-1, keepdim=True)) / torch.sqrt(
                xd.var(-1, unbiased=False, keepdim=True) + dit.LN_EPS)
                * (1 + ss[:, None, None, c:].double())
                + ss[:, None, None, :c].double())
            if bool(((out.double() - exact).abs()
                     > exact.abs() * 2.0 ** -8 + 1e-5).any()):
                raise AssertionError(f"L DiT {site}: more than one bf16 "
                                     "rounding from the float64 formula")
            del xd, exact
        del out, want, again
        elems = xb.numel()
        timed({"kernel": "layernorm_modulate", "site": site, "form": (
                  "codes" if codes else "bf16"), "batch": n,
               "dit_sites": DIT_L_CODES if codes else DIT_L - DIT_L_CODES,
               "max_abs_err": 0.0, "check": "equal to plain"},
              lambda: layernorm_modulate(xb, ss, eps=dit.LN_EPS, **kw),
              lambda: layernorm_modulate_plain(xb, ss, eps=dit.LN_EPS, **kw),
              (4 + 3 * codes) * elems,
              (2 + (1 if codes else 2)) * elems + 8 * n * c, PEAK_FP32_OPS)
    del y16

    # A's GELU form at fc1: the codes of GELU(y) at fc2's scale
    xq = torch.randint(-127, 128, (n, grid, grid, c), generator=g,
                       device=dev, dtype=torch.int8)
    wp = pack_conv(torch.randint(-127, 128, (1, 1, c, m), generator=g,
                                 device=dev, dtype=torch.int8))
    s = torch.rand(m, generator=g, device=dev) * 2e-5
    b = 0.2 * torch.randn(m, generator=g, device=dev)
    yf = conv2d_int8_plain(xq, wp, s, b, relu=False, out_float=True)
    ga = (torch.nn.functional.gelu(yf, approximate="tanh").abs().amax()
          / 127.0).reshape(1)
    del yf
    out = one_launch(conv2d_int8, "launches_gelu",
                     lambda: conv2d_int8(xq, wp, s, b, relu=False,
                                         gelu_scale=ga))
    want = conv2d_int8_plain(xq, wp, s, b, relu=False, gelu_scale=ga)
    diff = (out.int() - want.int()).abs()
    worst, off = int(diff.max()), float((diff > 0).float().mean())
    if worst > 1 or off >= 1e-4:
        raise AssertionError(f"A DiT fc1 GELU form: codes differ: max "
                             f"{worst}, {off:.4%} apart")
    if not torch.equal(conv2d_int8(xq, wp, s, b, relu=False, gelu_scale=ga),
                       out):
        raise AssertionError("A DiT fc1 GELU form: two launches differ")
    del out, want, diff
    tokens = n * grid * grid
    timed({"kernel": "conv_int8", "site": f"fc1 {n} x {grid}^2 x {c} -> {m}",
           "form": "gelu", "batch": n, "dit_sites": DIT_GELU,
           "max_abs_err": float(worst), "off_by_one": off,
           "float_out_ms": cuda_ms(lambda: conv2d_int8(
               xq, wp, s, b, relu=False, out_float=True), reps=10,
               flush=scrub.zero_),
           "check": f"max {worst} code apart ({off:.2e} of them)"},
          lambda: conv2d_int8(xq, wp, s, b, relu=False, gelu_scale=ga),
          lambda: conv2d_int8_plain(xq, wp, s, b, relu=False, gelu_scale=ga),
          2 * tokens * c * m, tokens * c + c * m + tokens * m + 8 * m,
          PEAK_INT8_OPS)
    del xq, wp

    # E's gated form: x + gate * y into the residual stream, in place
    y = torch.randn((n, grid, grid, c), generator=g, device=dev)
    gate = mods[:, 2 * c:3 * c]
    want = gated_residual_plain(xb.clone(), gate, y)
    xe = xb.clone()
    out = one_launch(bias_residual, "launches_gate",
                     lambda: gated_residual(xe, gate, y))
    if out is not xe or not torch.equal(out.view(torch.int16),
                                        want.view(torch.int16)):
        raise AssertionError("E DiT gated: not the plain version's bits in "
                             "place")
    if not torch.equal(gated_residual(xb.clone(), gate, y).view(torch.int16),
                       want.view(torch.int16)):
        raise AssertionError("E DiT gated: two launches differ")
    del want, out
    elems = xb.numel()
    # each launch writes xe in place: its sums grow from launch to launch,
    # which costs nothing in an add
    timed({"kernel": "bias_residual", "site": f"{n} x {grid}^2 x {c} gated",
           "form": "gate", "batch": n, "dit_sites": DIT_GATE,
           "max_abs_err": 0.0, "check": "equal to plain, in place"},
          lambda: gated_residual(xe, gate, y),
          lambda: gated_residual_plain(xe, gate, y),
          0, 2 * 2 * elems + 4 * elems + 4 * n * c, PEAK_FP32_OPS)
    del xb, xe, y
    lrows = [r for r in rows if r["kernel"] == "layernorm_modulate"]
    print(f"L a batch-{n} int8_deep DiT call: "
          f"{sum(r['ms'] * r['dit_sites'] for r in lrows):.3f} ms (bound "
          f"{sum(r['bound_ms'] * r['dit_sites'] for r in lrows):.3f}, plain "
          f"{sum(r['plain_ms'] * r['dit_sites'] for r in lrows):.3f}) "
          f"({card})")
    return {"launches": launches, "rel_to_plain": rel, "sites": rows,
            "a_1x1": a_1x1, "wall_s": time.perf_counter() - t0}


def notebook_1x1(dev, g):
    """Kernel A's 1x1 sites (:func:`record_1x1`) of one int8_deep call of
    the notebook net (``seeded_fastddpm``, calibrated on one batch over the
    10-step sampler) at batch CHECK_BATCH, for :func:`gemm_check`: its
    four skips, as many as ``diffusion_conv_sites`` lists."""
    from collections import Counter

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm, deep_sites, int8_forward, quantize_fastddpm)

    params = fastddpm_flax_params(seeded_fastddpm(0).to(dev))
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    cond = torch.randn((CHECK_BATCH, HW, HW, 2), generator=g, device=dev)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    fwd = int8_forward(quantize_fastddpm({"params": params}, calib,
                                         only=deep_sites(params)), device=dev)
    a_1x1 = Counter()
    record_1x1(fwd, a_1x1)
    x = torch.randn((CHECK_BATCH, HW, HW, 3), generator=g, device=dev)
    fwd(x, torch.full((CHECK_BATCH,), int(sched.timesteps[-1]), device=dev))
    torch.cuda.synchronize()
    want = sum(k == 1 for *_, k in diffusion_conv_sites())
    if sum(a_1x1.values()) != want:
        raise AssertionError(f"notebook int8_deep call: {dict(a_1x1)} 1x1 "
                             f"sites of A, want {want}")
    return a_1x1


def record_1x1(fwd, into):
    """Counts each 1x1 site of kernel A that ``fwd`` (an ``int8_forward``)
    launches into ``into``, a Counter of (H, W, Ci, Co, mode, relu) with
    mode ``"f32"``, ``"codes"`` or ``"gelu"``.  Returns the wrapped conv,
    for the caller to put back as ``fwd._conv8``."""
    conv8 = fwd._conv8

    def record(x, wp, s, b, **kw):
        if wp.shape[1] == 1:
            mode = ("gelu" if kw.get("gelu_scale") is not None else
                    "f32" if kw.get("out_float") else "codes")
            into[(x.shape[1], x.shape[2], x.shape[3], wp.shape[0], mode,
                  bool(kw.get("relu", True)))] += 1
        return conv8(x, wp, s, b, **kw)

    fwd._conv8 = record
    return conv8


def gemm_check(dev, g, card: str, nets):
    """Kernel A's 1x1 sites (``nets``: {net: Counter from
    :func:`record_1x1`}) at batch DDPM_BATCH on both tensor-core forms, the
    GEMM form and the conv form (a GELU site on the GEMM form alone, the
    only form with that epilogue): the same bits (float32, or codes), equal
    to the plain version's (the GELU form within one code of it, fewer than
    1e-4 of the codes apart), each form's time with the L2 flushed, the
    bound and the plain version's time; the form ``conv_form`` gives each
    and the sites where it is the slower.  The table behind the routing
    rule.  Returns the rows."""
    from mrisr_tpu_torch.ops.conv_int8 import (
        conv2d_int8, conv2d_int8_plain, conv_form, pack_conv)

    t0 = time.perf_counter()
    n, rows = DDPM_BATCH, []
    scrub = torch.empty(16 * 2 ** 20, device=dev)
    for net, sites in nets.items():
        for (h, w, ci, co, mode, relu), count in sorted(sites.items()):
            m = n * h * w
            x = torch.randint(-127, 128, (n, h, w, ci), generator=g,
                              device=dev, dtype=torch.int8)
            wp = pack_conv(torch.randint(-127, 128, (1, 1, ci, co),
                                         generator=g, device=dev,
                                         dtype=torch.int8))
            acc_std = 127 * 127 / 3 * ci ** 0.5
            s = (torch.rand(co, generator=g, device=dev) + 0.3) * 3 / acc_std
            b = 0.2 * torch.randn(co, generator=g, device=dev)
            kw = {"relu": relu, "out_float": mode == "f32"}
            if mode == "gelu":
                y = conv2d_int8_plain(x, wp, s, b, relu=False, out_float=True)
                kw = {"relu": False, "gelu_scale": (torch.nn.functional.gelu(
                    y, approximate="tanh").abs().amax() / 127.0).reshape(1)}
                del y
            forms = ("gemm",) if mode == "gelu" else ("gemm", "tc")
            # the rule's form is the GEMM form; "tc" forces the conv form
            force = {"gemm": None, "tc": "tc"}
            got = {f: conv2d_int8(x, wp, s, b, _form=force[f], **kw)
                   for f in forms}
            want = conv2d_int8_plain(x, wp, s, b, **kw)
            if not torch.equal(got["gemm"], got.get("tc", got["gemm"])):
                raise AssertionError(f"A {net} 1x1 {h}x{w} {ci}->{co} "
                                     f"{mode}: the two forms differ")
            if mode == "gelu":
                diff = (got["gemm"].int() - want.int()).abs()
                ok = int(diff.max()) <= 1 and float(
                    (diff > 0).float().mean()) < 1e-4
            else:
                ok = torch.equal(got["gemm"], want)
            if not ok:
                raise AssertionError(f"A {net} 1x1 {h}x{w} {ci}->{co} "
                                     f"{mode}: not the plain version's")
            del got, want
            ops = 2.0 * m * ci * co
            nbytes = m * ci + ci * co + 8 * co + m * co * (
                4 if mode == "f32" else 1)
            row = {"kernel": "conv_int8", "net": net, "site":
                   f"{n} x {h}x{w} x {ci} -> {co} {mode}", "sites": count,
                   # the GEMM form's 128 x 128 output tiles
                   "batch": n, "tiles": -(-m // 128) * -(-co // 128),
                   "form": conv_form(m, ci, co, 1), "ops": ops,
                   "bytes": nbytes, "ops_ms": ops / PEAK_INT8_OPS * 1e3,
                   "bytes_ms": nbytes / PEAK_BYTES * 1e3}
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["tc_ms"] = None  # the conv form has no GELU epilogue
            for f in forms:
                row[f"{f}_ms"] = cuda_ms(
                    lambda: conv2d_int8(x, wp, s, b, _form=force[f], **kw),
                    reps=10, flush=scrub.zero_)
            row["plain_ms"] = cuda_ms(
                lambda: conv2d_int8_plain(x, wp, s, b, **kw), reps=1,
                warmup=1)
            row["ms"] = row[f"{row['form']}_ms"]
            row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
            rows.append(row)
            del x, wp
            tc = row["tc_ms"]
            print(f"A {net:8s} 1x1 {row['site']:34s} x{count:2d}: "
                  f"{row['tiles']:5d} tiles, gemm {row['gemm_ms']:.4f} ms, "
                  + ("tc -, " if tc is None else f"tc {tc:.4f} ms, ")
                  + f"bound {row['bound_ms']:.4f}, "
                  f"plain {row['plain_ms']:.3f}; takes {row['form']} "
                  f"({row['pct_of_bound']:.1f} % of bound"
                  + (", SLOWER than the other form)" if tc is not None
                     and row["ms"] > min(row["gemm_ms"], tc) else ")"),
                  flush=True)
    for net in nets:
        sel = [r for r in rows if r["net"] == net]
        both = [r for r in sel if r["tc_ms"] is not None]
        took, gemm, tc = (sum(r[k] * r["sites"] for r in rs) for rs, k in (
            (sel, "ms"), (both, "gemm_ms"), (both, "tc_ms")))
        print(f"A 1x1 sites of a batch-{n} {net} call: "
              f"{sum(r['sites'] for r in sel)} sites, {took:.3f} ms as routed "
              f"({sum(r['sites'] for r in sel if r['form'] == 'gemm')} in "
              f"the GEMM form); the {sum(r['sites'] for r in both)} with "
              f"both forms {gemm:.3f} ms in the GEMM form, {tc:.3f} ms in "
              f"the conv form; bound "
              f"{sum(r['bound_ms'] * r['sites'] for r in sel):.3f} ms")
    slower = [r for r in rows if r["tc_ms"] is not None
              and r["ms"] > min(r["gemm_ms"], r["tc_ms"])]
    print(f"A 1x1: {len(rows)} distinct sites, the rule's form the slower "
          f"at {len(slower)} ({time.perf_counter() - t0:.1f} s; {card})")
    return rows


def quant_check(dev, g, ddpm_sites, card: str, adm_sites):
    """The quantizer at batch 32 at each distinct (H, C) of its inputs in
    one int8_deep call of the DDPM UNet (``ddpm_sites``: Counter of (H, C)),
    of ADM's UNet (``adm_sites``, the same) and of the notebook net
    (:func:`diffusion_quant_sites`), from bf16
    (what the forwards quantize) and float32, at a scale at which both ends
    of x saturate: the plain version's codes bit for bit, the same codes on a
    second launch, its ms against the byte bound (2 or 4 B read and 1 B
    written an element) and the plain version's ms.  Returns the rows."""
    from collections import Counter

    from mrisr_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    notebook = Counter((h, c) for _, h, c in diffusion_quant_sites())
    rows = []
    for h, c in sorted(set(ddpm_sites) | set(adm_sites) | set(notebook)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (3 * torch.randn((DDPM_BATCH, h, h, c), generator=g,
                                 device=dev)).to(dtype)
            # 127 a lies below both the largest and the smallest x
            a = (torch.minimum(x.amax(), -x.amin()).float() / 130.0
                 ).reshape(1)
            got = quantize_int8(x, a)
            want = quantize_int8_plain(x, a)
            what = f"quantizer {h}^2 x {c} {dtype}"
            check_exact(got, want, quantize_int8(x, a), what)
            if not (bool((want == 127).any()) and bool((want == -127).any())):
                raise AssertionError(f"{what}: no code saturates")
            del got, want
            nbytes = x.numel() * (x.element_size() + 1)
            bound, t_ops, t_bytes = bound_ms(0, nbytes)
            row = {"kernel": "quantize_int8", "site": f"{h}^2 C {c}",
                   "H": h, "C": c, "dtype": str(dtype).split(".")[-1],
                   "batch": DDPM_BATCH, "notebook_sites": notebook[(h, c)],
                   "ddpm_sites": ddpm_sites[(h, c)],
                   "adm_sites": adm_sites[(h, c)], "bytes": nbytes,
                   "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: quantize_int8(x, a), reps=10),
                   "plain_ms": cuda_ms(lambda: quantize_int8_plain(x, a),
                                       reps=10),
                   "library_ms": None, "bound_ms": bound, "ops_ms": t_ops,
                   "bytes_ms": t_bytes}
            row["pct_of_bound"] = 100.0 * bound / row["ms"]
            rows.append(row)
            del x
            print(f"quantizer {row['site']:12s} {row['dtype']:8s} x"
                  f"{row['notebook_sites']} notebook x{row['ddpm_sites']:2d} "
                  f"DDPM x{row['adm_sites']:2d} ADM: equal to plain, "
                  f"{row['ms']:.4f} ms, bound "
                  f"{bound:.4f} ({row['pct_of_bound']:.1f} %), plain "
                  f"{row['plain_ms']:.3f} ms")
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    print("quantizer a batch-32 int8_deep call, bf16: " + ", ".join(
        f"{net} {sum(r['ms'] * r[key] for r in bf16):.3f} ms (bound "
        f"{sum(r['bound_ms'] * r[key] for r in bf16):.3f}, plain "
        f"{sum(r['plain_ms'] * r[key] for r in bf16):.3f})"
        for net, key in (("notebook", "notebook_sites"),
                         ("DDPM", "ddpm_sites"), ("ADM", "adm_sites")))
          + f" ({card})")
    return rows


def bias_mode(r, rb) -> str:
    """Kernel E's mode of a call: 'bias' alone, with a 'residual' (the
    block's input), or with a 'shortcut' conv's output and its bias."""
    return "bias" if r is None else "residual" if rb is None else "shortcut"


def bias_check(dev, g, ddpm_sites, card: str):
    """Kernel E at batch 32 at each distinct (H, C, mode) of its calls in
    one int8_deep call of the DDPM UNet (``ddpm_sites``: Counter of them),
    bf16: the plain version's bits, in place (the same tensor back), r
    untouched, the same bits on a second launch, its ms against the byte
    bound (y read and written, r read: 4 or 6 B an element, the bias rows
    besides; the L2 flushed before each launch, as a 256^2 map is far
    past it) and the plain version's ms (torch's adds: the bias, the
    shortcut's bias, the residual).  Returns the rows."""
    from mrisr_tpu_torch.ops.bias_residual import (
        bias_residual, bias_residual_plain)

    def bits(t):
        return t.view(torch.int16)

    scrub, rows = torch.empty(32 * 2 ** 20, device=dev), []
    for (h, c, mode), n in sorted(ddpm_sites.items()):
        shape = (DDPM_BATCH, h, h, c)

        def draw(*s, scale=1.0):
            return (scale * torch.randn(s, generator=g, device=dev)).to(
                torch.bfloat16)

        y0, b = draw(*shape, scale=3.0), draw(c)
        r = None if mode == "bias" else draw(*shape, scale=2.0)
        rb = draw(c) if mode == "shortcut" else None
        r0 = None if r is None else r.clone()
        want = bias_residual_plain(y0.clone(), b, r, rb)
        y = y0.clone()
        got = bias_residual(y, b, r, rb)
        what = f"E {h}^2 x {c} {mode}"
        if got is not y or not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{what}: not the plain version's bits in "
                                 "place")
        if r is not None and not torch.equal(bits(r), bits(r0)):
            raise AssertionError(f"{what}: r was written")
        if not torch.equal(bits(bias_residual(y0.clone(), b, r, rb)),
                           bits(got)):
            raise AssertionError(f"{what}: two launches differ")
        del want, got, r0
        elems = y0.numel()
        nbytes = 2 * elems * (2 + (r is not None)) + 2 * c * (1 + (
            rb is not None))
        bound, t_ops, t_bytes = bound_ms(0, nbytes)
        row = {"kernel": "bias_residual", "site": f"{h}^2 C {c} {mode}",
               "H": h, "C": c, "mode": mode, "batch": DDPM_BATCH,
               "ddpm_sites": n, "bytes": nbytes, "max_abs_err": 0.0,
               # each launch writes y in place: its sums grow from launch
               # to launch, which costs nothing in an add
               "ms": cuda_ms(lambda: bias_residual(y, b, r, rb), reps=10,
                             flush=scrub.zero_),
               "plain_ms": cuda_ms(lambda: bias_residual_plain(y, b, r, rb),
                                   reps=10, flush=scrub.zero_),
               "library_ms": None, "bound_ms": bound, "ops_ms": t_ops,
               "bytes_ms": t_bytes}
        row["pct_of_bound"] = 100.0 * bound / row["ms"]
        rows.append(row)
        del y, y0, r
        print(f"E {row['site']:24s} x{n:2d} DDPM: equal to plain, "
              f"{row['ms']:.4f} ms, bound {bound:.4f} "
              f"({row['pct_of_bound']:.1f} %), plain {row['plain_ms']:.3f} "
              "ms")
    full = [r for r in rows if r["H"] == HW]
    print(f"E a batch-32 int8_deep DDPM call: "
          f"{sum(r['ms'] * r['ddpm_sites'] for r in rows):.3f} ms (bound "
          f"{sum(r['bound_ms'] * r['ddpm_sites'] for r in rows):.3f}, plain "
          f"{sum(r['plain_ms'] * r['ddpm_sites'] for r in rows):.3f}); at "
          f"{HW}^2 {sum(r['ms'] * r['ddpm_sites'] for r in full):.3f} ms "
          f"(bound {sum(r['bound_ms'] * r['ddpm_sites'] for r in full):.3f})"
          f" ({card})")
    return rows


# kernel -> (CUDA source, what it replaces).  Kernel A replaces no
# pallas_call: XLA generated the int8 conv (_conv3x3 at :66) and its
# requantizing epilogue (_requant_epilogue at :204) on the TPU; nor does
# the quantizer: XLA fused _quant_input (:236) into the conv reading it;
# nor does kernel E: XLA fused a float site's bias (:509) into its conv;
# nor does kernel L: the JAX package serves no transformer.
SOURCES = {
    "conv_int8": ("mrisr_tpu_torch/csrc/conv_int8.cu",
                  "mrisr_tpu/serve/quant.py:66"),
    "upconv_int8": ("mrisr_tpu_torch/csrc/upconv_int8.cu",
                    "mrisr_tpu/ops/upconv_pallas.py:130"),
    "ssim": ("mrisr_tpu_torch/csrc/ssim.cu",
             "mrisr_tpu/ops/ssim_pallas.py:91"),
    "groupnorm_silu": ("mrisr_tpu_torch/csrc/groupnorm_silu.cu",
                       "mrisr_tpu/ops/groupnorm_pallas.py:205"),
    "quantize_int8": ("mrisr_tpu_torch/csrc/quantize_int8.cu",
                      "mrisr_tpu/serve/quant.py:236"),
    "bias_residual": ("mrisr_tpu_torch/csrc/bias_residual.cu",
                      "mrisr_tpu/serve/quant_diffusion.py:509"),
    "layernorm_modulate": ("mrisr_tpu_torch/csrc/layernorm_modulate.cu",
                           None),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites-json", help="also write per-site numbers here")
    # one rank of phase 13's pair or of phase 14's four, started by the
    # phase itself
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-in", help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        dp_rank_main(args.dp_rank, args.dp_port, args.dp_in, args.dp_out)
        return 0
    if args.tp_rank is not None:
        tp_rank_main(args.tp_rank, args.dp_port, args.dp_in, args.dp_out)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    k3_rows = k3_phase(dev)
    diff_launches, diff_result = diffusion_phase(dev, card)
    step_ref = {}  # phase 8's float32 step reference, for phase 16
    with tempfile.TemporaryDirectory() as teachers:
        train_launches, train_result = train_phase(dev, card, teachers,
                                                   step_ref)
        family_launches, family_result = families_phase(dev, card, teachers)
        bf16_launches, bf16_result = bf16_phase(dev, card)
        distill_launches, distill_result = distill_phase(dev, card, teachers)
        ingest_launches, ingest_result = ingest_phase(dev, card, teachers)
        parallel_launches, parallel_result = parallel_phase(dev, card,
                                                            teachers)
    tp_launches, tp_result = tp_phase(dev, card)
    # no kernel is on phase 15's and 16's paths: their launches are counted
    # all the same
    names_result, names_launches = count_launches(
        lambda: names_phase(dev, card))
    remat_result, remat_launches = count_launches(
        lambda: remat_phase(dev, card, step_ref))
    print(f"remat phase kernel launches: {remat_launches} (no kernel is on "
          "its path)")
    ddpm_launches, ddpm_result = ddpm_phase(dev, card)

    kernels = []
    quant_rows = ddpm_result["quant_sites"]
    bias_rows = ddpm_result["bias_sites"]
    phases = {"serve": serve_launches, "eval": eval_launches,
              "diffusion": diff_launches, "train": train_launches,
              "families": family_launches, "bf16": bf16_launches,
              "distill": distill_launches, "ingest": ingest_launches,
              "parallel": parallel_launches, "model_axis": tp_launches,
              "names": names_launches, "remat": remat_launches,
              "ddpm": ddpm_launches, "adm": ddpm_result["adm"]["launches"],
              "dit": ddpm_result["dit"]["launches"]}
    dit_rows = ddpm_result["dit"]["sites"]
    gemm_rows = ddpm_result["gemm_sites"]
    for name in SOURCES:
        # A and B: all sites of one batch-8 UNet forward, summed; K1: one
        # call at N = 174, the eval's 3 mm test split; K3: the 10 sites of
        # one batch-8 int8_deep Fast-DDPM forward, summed; the quantizer:
        # the 6 bf16 sites of one batch-32 int8_deep notebook-net forward,
        # summed, checked at both nets' shapes; E: the 256^2 sites of one
        # batch-32 int8_deep DDPM UNet forward, summed, checked at all of
        # its sites; L: the 57 sites of one batch-32 int8_deep DiT forward,
        # summed
        sel = ([r for r in rows if r["kernel"] == name] if name in
               ("conv_int8", "upconv_int8") else
               [r for r in ssim_rows if r["N"] == 174] if name == "ssim" else
               [r for r in quant_rows if r["dtype"] == "bfloat16"
                for _ in range(r["notebook_sites"])]
               if name == "quantize_int8" else
               [r for r in bias_rows if r["H"] == HW
                for _ in range(r["ddpm_sites"])]
               if name == "bias_residual" else
               [r for r in dit_rows if r["kernel"] == name
                for _ in range(r["dit_sites"])]
               if name == "layernorm_modulate" else
               [r for r in k3_rows if r["kernel"] == name])
        checked = sel + [r for r in k3_rows + quant_rows + bias_rows
                         if r["kernel"] == name]
        ops_ms = sum(r["ops_ms"] for r in sel)
        bytes_ms = sum(r["bytes_ms"] for r in sel)
        libs = [r["library_ms"] for r in sel]

        def main_path(key):
            # the serving, eval, diffusion, training, families, bf16,
            # distillation, ingest, parallel, model-axis, names, remat,
            # DDPM, ADM and DiT paths' runs, each counted from 0 just
            # before it (phase 13's and 14's ranks count their own)
            return sum(launches.get(key, 0) for launches in phases.values())

        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": main_path(name),
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None if None in libs else sum(libs),
            "launches_model_axis": tp_launches.get(name, 0),
            "launches_by_phase": {k: v.get(name, 0)
                                  for k, v in phases.items()},
        }
        if name in ("conv_int8", "upconv_int8"):
            entry["launches_by_path"] = {p: main_path(f"{name}/{p}")
                                         for p in ("tc", "dp4a")}
        # A's GELU form and E's gated form: one launch at DiT's shape
        for r in dit_rows:
            if r["kernel"] == name and name != "layernorm_modulate":
                entry.setdefault("forms", {})[r["form"]] = {
                    "launches": main_path(f"{name}/{r['form']}"),
                    "site": r["site"], "max_abs_err": r["max_abs_err"],
                    **{k: r[k] for k in ("ms", "bound_ms", "plain_ms")}}
        # A's GEMM form: the 112 1x1 sites of a batch-32 DiT call, summed
        if name == "conv_int8":
            sel = [r for r in gemm_rows if r["net"] == "dit"]
            both = [r for r in sel if r["tc_ms"] is not None]
            entry.setdefault("forms", {})["gemm"] = {
                "launches": main_path("conv_int8/gemm"),
                "site": "the 1x1 sites of a batch-32 DiT call",
                **{k: sum(r[k] * r["sites"] for r in sel) for k in (
                    "ms", "bound_ms", "plain_ms")},
                # the float32 sites, which the conv form takes too
                "both_forms_sites": sum(r["sites"] for r in both),
                **{k: sum(r[k] * r["sites"] for r in both) for k in (
                    "gemm_ms", "tc_ms")}}
        kernels.append(entry)
    if args.sites_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.sites_json)),
                    exist_ok=True)
        with open(args.sites_json, "w") as f:
            json.dump({"card": card, "sites": rows + ssim_rows + k3_rows,
                       "slice": slice_result, "eval": eval_result,
                       "diffusion": diff_result, "train": train_result,
                       "families": family_result, "bf16": bf16_result,
                       "distill": distill_result, "ingest": ingest_result,
                       "parallel": parallel_result, "model_axis": tp_result,
                       "names": names_result, "remat": remat_result,
                       "ddpm": ddpm_result, "kernels": kernels}, f,
                      indent=1)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s "
          f"(kernel build included; {card})")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
