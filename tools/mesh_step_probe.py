#!/usr/bin/env python3
"""Which of a data-parallel train step's bits depend on the mesh, and
which on the process's history, on the card.

    python3 tools/mesh_step_probe.py [--cudnn on|off]

Four ranks share the one card over gloo (this script with ``--rank``).
Each takes five float32 ``unet_combined`` steps at full width (global
batch 4, 256^2, augmentation off, TF32 off, deterministic algorithms,
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), each from the same seeded weights:
S1 on the 2 x 2 mesh, S2 and S3 on the 2 x 1 mesh of its pair (ranks 0-1
or 2-3), S4 on the 2 x 2 mesh, S5 on its pair.  Every rank hashes each
all-reduce's input and output, each conv's forward input and output, and
its own gradients before the step's all-reduce.  For pairs of steps that
take the same rows, the script prints the first all-reduce and the first
conv whose output differs, and how many of the 82 gradients are equal.
``--cudnn``: cuDNN as the port runs it (on) or disabled (off).  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RANKS = 4
HW, FEATURES, BATCH = 256, 64, 4
PLAN = (("S1", "2x2"), ("S2", "pair"), ("S3", "pair"), ("S4", "2x2"),
        ("S5", "pair"))
# (what, (rank, step), (rank, step)): the same rows each time
PAIRS = (
    ("rank 0, rows 0-1: S1 (2x2, its first step) vs S2 (pair)",
     (0, "S1"), (0, "S2")),
    ("rank 0, rows 0-1: S1 vs S4 (both 2x2)", (0, "S1"), (0, "S4")),
    ("rank 0, rows 0-1: S2 vs S3 (both pair)", (0, "S2"), (0, "S3")),
    ("rank 0, rows 0-1: S4 (2x2) vs S5 (pair)", (0, "S4"), (0, "S5")),
    ("rows 2-3: rank 2's S1 (2x2) vs rank 1's S2 (pair)",
     (2, "S1"), (1, "S2")),
    ("rows 0-1: rank 2's S2 (pair 2-3) vs rank 0's S2 (pair 0-1)",
     (2, "S2"), (0, "S2")),
    ("rows 0-1, S1: the 2x2's model copies, ranks 0 and 1",
     (0, "S1"), (1, "S1")),
)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def rank_main(rank: int, port: int, cudnn: str, out: str) -> None:
    import torch.distributed as dist

    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.parallel.mesh import (
        MeshSpec, distributed_init, make_mesh, shard_batch)
    from mrisr_tpu_torch.train import SupervisedTrainer

    dev = torch.device("cuda")
    distributed_init(f"localhost:{port}", RANKS, rank, backend="gloo")
    meshes = {"2x2": make_mesh(MeshSpec(data=2, model=2), device=dev),
              "pair": (make_mesh(MeshSpec(data=2), devices=[0, 1],
                                 device=dev),
                       make_mesh(MeshSpec(data=2), devices=[2, 3],
                                 device=dev))}
    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=BATCH, augment=False),
        model=dataclasses.replace(base.model, base_features=FEATURES))
    batch = torch.randn(BATCH, HW, HW, 3,
                        generator=torch.Generator().manual_seed(41))
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.enabled = cudnn == "on"
    reduces = []
    all_reduce = dist.all_reduce

    def hashed_all_reduce(t, *args, **kwargs):
        before = digest(t)
        work = all_reduce(t, *args, **kwargs)
        reduces.append((list(t.shape), before, digest(t)))
        return work

    dist.all_reduce = hashed_all_reduce
    res = {}
    for tag, kind in PLAN:
        mesh = meshes[kind] if kind == "2x2" else meshes[kind][rank // 2]
        trainer = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn(
            cfg.loss.perceptual), device=dev, mesh=mesh)
        convs, local = [], {}
        for name, m in trainer.state.module.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.register_forward_hook(
                    lambda m, a, y, name=name: convs.append(
                        (name, digest(a[0]), digest(y))))
        for name, p in trainer.state.module.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, name=name: local.__setitem__(name, digest(p.grad)))
        reduces.clear()
        trainer.train_step(trainer.state,
                           shard_batch(batch, mesh).to(dev))
        res[tag] = {"rows": mesh.rows(BATCH).start, "reduces": list(reduces),
                    "convs": convs, "local": local}
        del trainer
        meshes["2x2"].barrier()
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def compare(a: dict, b: dict) -> dict:
    first = next((i for i, (x, y) in enumerate(zip(a["reduces"],
                                                   b["reduces"]))
                  if x[2] != y[2]), None)
    conv = next((x[0] for x, y in zip(a["convs"], b["convs"])
                 if x[1] == y[1] and x[2] != y[2]), None)
    return {"same_rows": a["rows"] == b["rows"],
            "first_all_reduce_differing": None if first is None else
            {"index": first, "of": len(a["reduces"]),
             "shape": a["reduces"][first][0],
             "input_differs": a["reduces"][first][1] != b["reduces"][first][1]},
            "first_conv_differing_at_equal_input": conv,
            "grads_equal": sum(a["local"][n] == b["local"][n]
                               for n in a["local"]),
            "of": len(a["local"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cudnn", choices=("on", "off"), default="on")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.port, args.cudnn, args.out)
        return 0
    if not torch.cuda.is_available():
        print("mesh_step_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with tempfile.TemporaryDirectory() as work:
        outs = [os.path.join(work, f"rank{r}.json") for r in range(RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--port", str(port), "--cudnn", args.cudnn, "--out", outs[r]],
            env=env) for r in range(RANKS)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            print(f"ranks exited {rcs}", file=sys.stderr)
            return 1
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    for what, (ra, sa), (rb, sb) in PAIRS:
        print(f"cudnn {args.cudnn}, {what}: "
              f"{compare(ranks[ra][sa], ranks[rb][sb])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
