"""Command-line interface of the port (counterpart: ``mrisr_tpu/cli.py``):

  python -m mrisr_tpu_torch extract <zip> <out_dir>
  python -m mrisr_tpu_torch clean <dataset_root> [--dry-run | --yes]
  python -m mrisr_tpu_torch pack <dicom_root> <out_store> [--slices 60]
  python -m mrisr_tpu_torch synth <out_store> [--patients 8]
  python -m mrisr_tpu_torch train --preset unet_combined --data <store> [...]
  python -m mrisr_tpu_torch eval --model unet --data <store> [...]
  python -m mrisr_tpu_torch predict-volume --model unet --data <store> \
      [--figure f.png] [--export-dicom DIR] [...]
  python -m mrisr_tpu_torch compare --model unet deepcnn ... [--from-results]
  python -m mrisr_tpu_torch triplet-figure --model unet --data <store> [...]
  python -m mrisr_tpu_torch export-serving --model fastddpm \
      --quant int8_deep --data <store> --out <bundle> [...]
  python -m mrisr_tpu_torch distill --teacher unet --data <store> [...]
  python -m mrisr_tpu_torch distill-steps --teacher fastddpm --data <store>
  python -m mrisr_tpu_torch serve --bundle <bundle> [--port 8000]

The arguments are the JAX CLI's, plus ``--device`` (default: the card;
``--device cpu`` runs the plain versions on the CPU).  ``extract``,
``clean`` and ``pack`` turn the Prostate-MRI-US-Biopsy download into a
store with the port's own DICOM reader (``data/dicom_lite.py``, struct and
numpy only, no pydicom; the native header scanner ``data/dicom_fast.py``
when a C compiler is there).  ``predict-volume --export-dicom`` writes each
model's predicted volume as a DICOM series with the same reader's writer,
and ``--figure``, ``compare`` and ``triplet-figure`` draw and tabulate the
comparisons (the figures need matplotlib and say so when it is missing).
``train`` trains every family's preset: the pair UNets, DeepCNN, the
Progressive UNet (on 5-slice windows), the UNet-GAN and both Fast-DDPM
lineages; ``distill`` trains the ``unet_distilled`` student against a
teacher checkpoint, and ``distill-steps`` the Fast-DDPM's few-step students
(``<teacher>_steps<N>_best.pt`` + ``_grid.json``), which ``eval``,
``predict-volume`` and ``export-serving`` take as ``--model
fastddpm_steps5``.  ``--bf16`` sets ``train.compute_dtype='bfloat16'``, as
the JAX CLI does: ``train`` then builds its models in bf16 compute (float32
parameters, loss and optimizer); ``eval``, ``predict-volume`` and
``export-serving`` take the flag and run as without it, since only the
trainers read the field.  ``export-serving`` writes pair UNets as
int8_fused, int8 or none (bf16) bundles, and ``serve`` answers HTTP
requests from a bundle.  Every subcommand of the JAX CLI is here but
``bench``, which comes with the port's benchmark.

Data parallelism (``--mesh-data``, ``parallel/mesh.py``): ``train`` and
``distill`` run one process a rank under ``torchrun``, which forms the
process group from its environment (NCCL on the card, gloo with
``--device cpu``)::

  python -m torch.distributed.run --nproc-per-node 2 -m mrisr_tpu_torch \
      train --preset unet_combined --data <store> --mesh-data 2 [...]

the world size playing the JAX CLI's visible-device count: an explicit
``--mesh-data N`` is honored strictly (N x model ranks, a batch that
divides by N), the default shrinks to gcd(batch, world), one rank runs the
unmeshed program.  ``--mesh-model M`` adds the JAX CLI's 'model' axis: the
state replicated over the whole mesh and the batch sharded on 'data' only,
as the JAX trainers run it, so the M data groups run the same program and
the first rank writes.  Every command takes the JAX CLI's common flags;
the others ignore the training ones, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import re
import sys

from mrisr_tpu_torch.config import PRESETS, Config


def _add_common_args(p: argparse.ArgumentParser,
                     data_required: bool = True) -> None:
    """The JAX CLI's common flags (``mrisr_tpu/cli.py:
    _add_common_train_args``), which every command takes, plus
    ``--device``."""
    p.add_argument("--data", required=data_required,
                   help="packed VolumeStore dir")
    p.add_argument("--batch-size", type=int, default=None)
    # None = "not passed": the preset's value is kept
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--distance", type=int, default=None, choices=(2, 4))
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--results-dir", default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute: train.compute_dtype='bfloat16' "
                        "(read by train; eval, predict-volume and "
                        "export-serving run as without it)")
    p.add_argument("--backend", default="host", choices=("host", "device"),
                   help="slice bank in host RAM or on the device")
    p.add_argument("--features", type=int, default=None,
                   help="base feature width override (default 64)")
    p.add_argument("--allow-fresh", action="store_true",
                   help="permit eval/predict with freshly initialized "
                        "weights when no checkpoint exists (default: the "
                        "CLI refuses; random-weight metrics are noise)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, under "
                        "torchrun this rank's; 'cpu' runs the plain "
                        "versions)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate override (default: preset value)")
    p.add_argument("--lr-schedule", default=None,
                   choices=("constant", "cosine"),
                   help="'cosine' decays to 0 over the full --epochs budget")
    p.add_argument("--patience", type=int, default=None,
                   help="early-stopping patience override (epochs)")
    p.add_argument("--train-seed", type=int, default=None,
                   help="training seed override (init; default: preset 0)")
    p.add_argument("--light-checkpoints", action="store_true",
                   help="save only the best (async) and one final latest "
                        "checkpoint, no per-epoch snapshots")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest <preset>_epoch_<N>.pt")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size (-1 = all ranks; "
                        "default: all ranks when >1 run under torchrun)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="model (tensor-parallel) mesh axis size (default 1)")
    p.add_argument("--shard-hosts", action="store_true",
                   help="each process loads only its own patient shard "
                        "(round-robin, rank and world size from "
                        "torch.distributed)")


def _build_config(args, preset_name: str):
    """The preset (or the ``--config`` file) with the flags that were
    passed applied; reflects the effective checkpoint/results dirs and
    image size back onto ``args``."""
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_dict(json.load(f))
    else:
        cfg = PRESETS[preset_name]
    data = dataclasses.replace(
        cfg.data,
        root=args.data,
        **({"image_size": (args.image_size, args.image_size)}
           if args.image_size else {}),
        **({"batch_size": args.batch_size} if args.batch_size else {}),
        **({"distance_filter": args.distance} if args.distance else {}),
    )
    flags = {"epochs": "epochs", "lr": "learning_rate",
             "lr_schedule": "lr_schedule",
             "patience": "early_stopping_patience", "train_seed": "seed"}
    train = dataclasses.replace(
        cfg.train,
        **({"checkpoint_dir": args.checkpoint_dir}
           if args.checkpoint_dir else {}),
        **({"results_dir": args.results_dir} if args.results_dir else {}),
        **({"compute_dtype": "bfloat16"} if args.bf16 else {}),
        **{field: getattr(args, flag) for flag, field in flags.items()
           if getattr(args, flag, None) is not None},
        **({"save_every_epoch": False, "light_checkpoints": True}
           if getattr(args, "light_checkpoints", False) else {}),
    )
    model = cfg.model
    if args.features:
        model = dataclasses.replace(model, base_features=args.features)
    mesh = dataclasses.replace(
        cfg.mesh, **{field: getattr(args, flag) for flag, field in (
            ("mesh_data", "data"), ("mesh_model", "model"))
            if getattr(args, flag, None) is not None})
    cfg = dataclasses.replace(cfg, data=data, train=train, model=model,
                              mesh=mesh)
    args.checkpoint_dir = cfg.train.checkpoint_dir
    args.results_dir = cfg.train.results_dir
    args.image_size = cfg.data.image_size[0]
    return cfg


def _preset_for(name: str) -> str:
    """Preset key for a model name: a step-distilled student
    ('fastddpm_steps5') takes its base's; a name with no preset, 'unet's."""
    base = re.sub(r"_steps\d+$", "", name)
    return base if base in PRESETS else "unet"


def cmd_synth(args) -> None:
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store

    store = make_synthetic_store(
        args.out, num_patients=args.patients,
        slices_per_volume=args.slices, height=args.size, width=args.size,
        seed=args.seed,
    )
    print(f"packed {len(store)} synthetic series -> {args.out}")


def cmd_extract(args) -> None:
    from mrisr_tpu_torch.data.extract import extract_zip

    ok, failed = extract_zip(args.zip, args.out, verbose=True)
    print(f"extracted {ok} members, {failed} failed")


def cmd_clean(args) -> None:
    """Delete the dataset's ultrasound and 3D-rendering series
    (``data/clean.py``): list them, then ask, unless ``--yes`` or
    ``--dry-run``."""
    from mrisr_tpu_torch.data.clean import clean_dataset, scan_dataset

    to_delete, total = scan_dataset(args.root)
    print(f"total series: {total}; to delete: {len(to_delete)}")
    for item in to_delete[:5]:
        print(f"  {item.patient}/{item.study}/{item.series}")
    if len(to_delete) > 5:
        print(f"  ... and {len(to_delete) - 5} more")
    if args.dry_run:
        print("dry run: nothing deleted")
        return
    if not args.yes:
        answer = input("Proceed with DELETION? (yes/no): ").strip().lower()
        if answer != "yes":
            print("cancelled")
            return
    removed = clean_dataset(to_delete)
    print(f"removed {removed} series; kept {total - removed}")


def cmd_pack(args) -> None:
    from mrisr_tpu_torch.data.volumes import VolumeStore

    store = VolumeStore.pack_dicom_tree(args.out, args.root,
                                        require_slices=args.slices)
    print(f"packed {len(store)} series -> {args.out}")


def _training_mesh(cfg: Config, device):
    """The data x model mesh of ``cfg.mesh`` (counterpart:
    ``mrisr_tpu/cli.py:_training_mesh``), the process group's world size
    playing the visible device count.  None for one rank: the unmeshed
    program.

    An explicit ``--mesh-data d`` takes the first d * model ranks, a
    model-only ``--mesh-model m`` every rank (data = world // m); the
    default (data=-1, model=1) shrinks the data axis to gcd(batch, world)
    and takes the first ranks.  The state is replicated over the whole
    mesh, as the JAX trainers replicate it, so the ``model`` data groups
    run the same program.  Every rank of the group calls it (the groups
    are made collectively); a rank outside the mesh sits the run out."""
    import math

    from mrisr_tpu_torch.parallel.mesh import (
        MeshSpec,
        global_rank,
        make_mesh,
        world_size,
    )

    world = world_size()
    # an explicit request is honored strictly: training on fewer ranks
    # under the user's nose is worse than an error
    _check_mesh(cfg.mesh.data, cfg.mesh.model, world)
    if world == 1:
        return None
    if cfg.mesh.data > 0 or cfg.mesh.model > 1:
        model = max(cfg.mesh.model, 1)
        if cfg.mesh.data > 0:
            mesh = make_mesh(MeshSpec(data=cfg.mesh.data, model=model),
                             devices=list(range(cfg.mesh.data * model)),
                             device=device)
        else:  # model-only request: the data axis takes every other rank
            mesh = make_mesh(MeshSpec(data=-1, model=model), device=device)
        n = mesh.size
        if cfg.data.batch_size % n != 0:
            raise SystemExit(
                f"batch_size {cfg.data.batch_size} is not divisible by the "
                f"mesh's data axis ({n}); pass --batch-size k*{n} or shrink "
                "the mesh with --mesh-data")
        return mesh
    n = math.gcd(cfg.data.batch_size, world)
    if n < world and global_rank() == 0:
        print(f"note: data axis shrunk to {n} of {world} devices (largest "
              f"divisor of batch_size {cfg.data.batch_size}); raise "
              "--batch-size to use all chips")
    if n <= 1:
        return None
    return make_mesh(MeshSpec(data=n), devices=list(range(n)), device=device)


def _check_mesh(data: int, model: int, world: int) -> None:
    """The JAX CLI's refusals of an explicit mesh the ranks cannot hold
    (``data``: -1 = all remaining ranks)."""
    model = max(model, 1)
    if world == 1:
        if max(data, 1) * model > 1:
            raise SystemExit(
                f"--mesh-data/--mesh-model requests {max(data, 1)}x{model} "
                "devices but only 1 is visible")
        return
    if data > 0 and data * model > world:
        raise SystemExit(
            f"--mesh-data/--mesh-model requests {data * model} devices but "
            f"only {world} are visible")


def _check_mesh_flags(args) -> None:
    """The commands that do not train take the mesh flags and ignore them,
    as the JAX CLI does, once they pass the training commands' rules (the
    visible count: the process group's ranks, else torchrun's
    ``WORLD_SIZE``)."""
    from mrisr_tpu_torch.parallel.mesh import world_size

    _check_mesh(args.mesh_data or -1, args.mesh_model or 1,
                max(world_size(), int(os.environ.get("WORLD_SIZE", "1"))))


def _sits_out(mesh) -> bool:
    """A rank with no part in the run: outside the data mesh, or any rank
    but the first when the run is unmeshed."""
    from mrisr_tpu_torch.parallel.mesh import global_rank

    if mesh is None:
        return global_rank() != 0
    return not mesh.member


def _meshed(fn):
    """Run a training command inside the process group it forms from
    torchrun's environment (NCCL on the card, gloo for ``--device cpu``),
    and leave the group after."""
    import functools

    @functools.wraps(fn)
    def run(args):
        import torch

        from mrisr_tpu_torch.parallel.mesh import distributed_init_from_env

        cpu = (args.device is not None
               and torch.device(args.device).type == "cpu")
        formed = distributed_init_from_env(backend="gloo" if cpu else None)
        try:
            return fn(args)
        finally:
            if formed:
                import torch.distributed as dist

                dist.destroy_process_group()

    return run


def _mesh_loader_args(cfg: Config, device):
    """(mesh, sharding) of a training command, printing the mesh."""
    from mrisr_tpu_torch.parallel.mesh import batch_sharding

    mesh = _training_mesh(cfg, device)
    if mesh is None:
        return None, None
    if mesh.first:
        print(f"training mesh: {mesh.shape}")
    return mesh, batch_sharding(mesh)


def make_trainer(cfg: Config, steps_per_epoch: int, device, mesh=None):
    """The trainer of ``cfg``'s family, by ``loss.kind``: 'gan' ->
    ``GANTrainer``, 'diffusion' -> ``DiffusionTrainer``, else
    ``SupervisedTrainer`` (pair models, and the Progressive UNet's
    windows); ``mesh``: data parallel over its ranks."""
    from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
    from mrisr_tpu_torch.train import (
        DiffusionTrainer,
        GANTrainer,
        SupervisedTrainer,
    )

    kind = cfg.loss.kind
    if kind == "gan":
        return GANTrainer(cfg, make_perceptual_fn(cfg.loss.perceptual),
                          steps_per_epoch=steps_per_epoch, device=device,
                          mesh=mesh)
    if kind == "diffusion":
        return DiffusionTrainer(cfg, steps_per_epoch=steps_per_epoch,
                                device=device, mesh=mesh)
    perceptual_fn = (make_perceptual_fn(cfg.loss.perceptual)
                     if kind == "combined" else None)
    return SupervisedTrainer(cfg, perceptual_fn=perceptual_fn,
                             steps_per_epoch=steps_per_epoch, device=device,
                             mesh=mesh)


@_meshed
def cmd_train(args):
    """Train the preset's family on ``--device`` and write
    ``<preset>_{best,latest,epoch_N}.pt``; returns the trainer (None on a
    rank that sits the run out).  Under torchrun, data parallel over the
    ranks (:func:`_training_mesh`)."""
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.device import resolve_device

    cfg = _build_config(args, args.preset)
    if cfg.loss.kind == "distill":
        raise SystemExit(
            "preset 'unet_distilled' trains against a teacher checkpoint: "
            "use python -m mrisr_tpu_torch distill --teacher unet ...")
    if args.scan_epochs and args.backend != "device":
        raise SystemExit("--scan-epochs requires --backend device")
    device = resolve_device(args.device)
    mesh, sharding = _mesh_loader_args(cfg, device)
    if _sits_out(mesh):
        return None
    store = VolumeStore.open(args.data)
    kind = "window" if cfg.model.name == "progressive_unet" else "triplet"
    train_loader = build_loader(store, "train", cfg.data, kind=kind,
                                backend=args.backend, device=device,
                                shard_by_host=args.shard_hosts,
                                sharding=sharding)
    # the val loader is not sharded, as the JAX CLI builds it: every rank
    # evaluates the whole split (its partial last batch included)
    val_loader = build_loader(store, "val", cfg.data, kind=kind,
                              backend=args.backend, device=device)
    trainer = make_trainer(cfg, len(train_loader), device, mesh)
    return _fit(trainer, args, train_loader, val_loader)


def _fit(trainer, args, train_loader, val_loader):
    """The training commands' common tail: ``--scan-epochs``,
    ``--resume`` (every rank loads), fit; returns the trainer."""
    if args.scan_epochs:
        trainer.enable_device_epochs(train_loader.bank, train_loader.plan_flat)
    if args.resume and trainer.try_resume() and trainer._writes:
        print(f"resumed from epoch {trainer.start_epoch - 1}")
    hist = trainer.fit(train_loader, val_loader)
    if trainer._writes:
        print(f"best val loss: {hist.extra.get('best_val_loss'):.4f}")
    return trainer


@_meshed
def cmd_distill(args):
    """Serving distillation (``serve/distill.py``): train the reduced-width
    UNet student against a trained teacher checkpoint on ``--device``.  The
    student lands as ``<preset>_best.pt``, so ``eval --model
    unet_distilled`` and the serving engine load it like any pair model;
    returns the trainer (None on a rank that sits the run out).  Under
    torchrun the student trains data parallel, and the int8 teacher runs
    on each rank's rows."""
    import itertools

    from mrisr_tpu_torch.config import ModelConfig
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.device import resolve_device
    from mrisr_tpu_torch.serve.distill import DistillationTrainer

    cfg = _build_config(args, args.preset)
    loss_over = {field: getattr(args, flag) for flag, field in (
        ("distill_alpha", "distill_alpha"),
        ("distill_lambda_ssim", "distill_lambda_ssim"),
        ("ema", "distill_ema")) if getattr(args, flag) is not None}
    if loss_over:
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, **loss_over))
    if args.scan_epochs and args.backend != "device":
        raise SystemExit("--scan-epochs requires --backend device")
    device = resolve_device(args.device)
    mesh, sharding = _mesh_loader_args(cfg, device)
    if _sits_out(mesh):
        return None
    store = VolumeStore.open(args.data)
    train_loader = build_loader(store, "train", cfg.data, kind="triplet",
                                backend=args.backend, device=device,
                                shard_by_host=args.shard_hosts,
                                sharding=sharding)
    val_loader = build_loader(store, "val", cfg.data, kind="triplet",
                              backend=args.backend, device=device)
    teacher_cfg = None
    if args.teacher_features:
        teacher_cfg = ModelConfig(name=args.teacher,
                                  base_features=args.teacher_features)
    calib_batches = None
    if args.teacher_quant != "none":
        # the quantized teacher calibrates on 4 val inputs, as
        # export-serving's bundles do
        calib_batches = [b[..., :2]
                         for b in itertools.islice(iter(val_loader), 4)]
    trainer = DistillationTrainer(
        cfg, teacher_name=args.teacher,
        teacher_models_dir=args.teacher_dir or args.checkpoint_dir,
        teacher_cfg=teacher_cfg, teacher_quant=args.teacher_quant,
        teacher_calibration_batches=calib_batches,
        init_from_teacher=args.init_from_teacher,
        steps_per_epoch=len(train_loader), device=device, mesh=mesh)
    return _fit(trainer, args, train_loader, val_loader)


def cmd_distill_steps(args):
    """Progressive step-distillation of a trained Fast-DDPM checkpoint
    (``serve/distill_diffusion.py``): the sampler grid shrinks by
    ``--factor``, ``--rounds`` times (T = 10 -> 5 -> 3).  Each round writes
    ``<teacher>_steps<N>_best.pt`` and ``<teacher>_steps<N>_grid.json``;
    the per-round test-set eval (the teacher's and each student's, every
    sampler call seeded 0) and the histories go to
    ``<teacher>_stepdistill.json``.  Returns that dict."""
    import torch

    from mrisr_tpu_torch.api import LoadedModel, load_model
    from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.device import resolve_device
    from mrisr_tpu_torch.eval.runner import evaluate_pair_model_test_set
    from mrisr_tpu_torch.serve.distill_diffusion import progressive_distill

    if args.teacher not in PRESETS or \
            PRESETS[args.teacher].loss.kind != "diffusion":
        raise SystemExit(
            f"--teacher must be a diffusion preset, got {args.teacher!r}")
    cfg = _build_config(args, args.teacher)
    device = resolve_device(args.device)
    store = VolumeStore.open(args.data)
    loaded = load_model(args.teacher,
                        models_dir=args.teacher_dir or args.checkpoint_dir,
                        checkpoint="required", cfg=cfg.model, device=device)
    train_loader = build_loader(store, "train", cfg.data, kind="triplet",
                                backend=args.backend, device=device)
    val_loader = build_loader(store, "val", cfg.data, kind="triplet",
                              backend=args.backend, device=device)
    rounds = progressive_distill(
        loaded.module, loaded.schedule, train_loader, val_loader,
        rounds=args.rounds, factor=args.factor, epochs=cfg.train.epochs,
        learning_rate=cfg.train.learning_rate)

    def _eval(model):
        return evaluate_pair_model_test_set(
            model.predict_nhwc, store, cfg.data,
            max_batches=args.max_eval_batches, device=device)

    results = {}
    if not args.no_eval:
        results["teacher"] = _eval(loaded)
        print(f"teacher ({loaded.schedule.num_inference_steps} steps): "
              f"{json.dumps(results['teacher'])}")
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    os.makedirs(args.results_dir, exist_ok=True)
    for student, sched, hist in rounds:
        name = f"{args.teacher}_steps{sched.num_inference_steps}"
        torch.save(reference_checkpoint(student, args.teacher),
                   os.path.join(args.checkpoint_dir, f"{name}_best.pt"))
        with open(os.path.join(args.checkpoint_dir,
                               f"{name}_grid.json"), "w") as f:
            json.dump({"base": args.teacher, "factor": args.factor,
                       "timesteps": [int(t) for t in sched.timesteps]}, f)
        entry = {"history": hist}
        if not args.no_eval:
            entry["eval"] = _eval(LoadedModel(
                name=name, module=student, kind="diffusion", device=device,
                schedule=sched, sampler="ddim_grid"))
            for sp in ("3mm", "6mm"):
                if sp in entry["eval"] and sp in results.get("teacher", {}):
                    entry["ssim_delta_vs_teacher_" + sp] = round(
                        entry["eval"][sp]["ssim_mean"]
                        - results["teacher"][sp]["ssim_mean"], 6)
            print(f"{name}: {json.dumps(entry['eval'])}")
        results[name] = entry
        print(f"saved {name}_best.pt + {name}_grid.json")
    out = os.path.join(args.results_dir, f"{args.teacher}_stepdistill.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out}")
    return results


def cmd_eval(args) -> None:
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.eval.runner import (
        evaluate_and_save,
        evaluate_progressive_test_set,
    )

    cfg = _build_config(args, _preset_for(args.model))
    store = VolumeStore.open(args.data)
    model = load_model(args.model, models_dir=args.checkpoint_dir,
                       cfg=cfg.model, device=args.device,
                       checkpoint=None if args.allow_fresh else "required")
    out = os.path.join(args.results_dir, f"{args.model}_test_metrics.json")
    kwargs = dict(mode=args.metric_mode, max_batches=args.max_batches,
                  backend=args.backend, device=model.device)
    if model.kind == "window":
        metrics = evaluate_progressive_test_set(model.predict_nhwc, store,
                                                cfg.data, **kwargs)
        os.makedirs(args.results_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump(metrics, f, indent=2)
    else:
        metrics = evaluate_and_save(model.predict_nhwc, store, cfg.data,
                                    out_json=out, **kwargs)
    print(json.dumps(metrics, indent=2))


def _test_volume(store, seed: int):
    """V1: a seeded random series of the test split, and the seeded
    ``random.Random`` that picked it (``triplet-figure`` draws on)."""
    from mrisr_tpu_torch.data.split import split_for

    candidates = store.series_for_patients(
        split_for(store.patient_ids, "test"))
    rng = random.Random(seed)
    rng.shuffle(candidates)
    if not candidates:
        print("no test-set series found", file=sys.stderr)
        sys.exit(1)
    return store.load_series(candidates[0]), rng


def _load_for(args, name: str):
    """``name``'s model and config: its own preset's (unet_distilled's
    width, fastddpm's schedule) with the flags that were passed."""
    from mrisr_tpu_torch.api import load_model

    cfg = _build_config(args, _preset_for(name))
    return load_model(name, models_dir=args.checkpoint_dir, cfg=cfg.model,
                      device=args.device,
                      checkpoint=None if args.allow_fresh else "required"
                      ), cfg


def cmd_predict_volume(args) -> dict:
    """Predict a seeded test-split volume with each ``--model`` (a window
    model through ``predict_volume_progressive``, a pair model through
    ``predict_volume`` or, with ``--hierarchical``, the cascade), print its
    metrics, and optionally export each prediction as a DICOM series
    (``DIR/<model>/``) and draw the comparison figure.  Returns the results
    by model."""
    import numpy as np

    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.eval import figures
    from mrisr_tpu_torch.eval.volume_eval import (
        predict_volume,
        predict_volume_hierarchical,
        predict_volume_progressive,
    )

    if args.figure:
        figures.pyplot()  # before the predictions: no matplotlib, no run
    cfg = _build_config(args, "unet")
    volume = np.asarray(_test_volume(VolumeStore.open(args.data),
                                     args.seed)[0])
    hw = cfg.data.image_size
    results = {}
    for name in args.model:
        model, _ = _load_for(args, name)
        if model.kind == "window":
            predict = predict_volume_progressive
        elif args.hierarchical:
            predict = predict_volume_hierarchical
        else:
            predict = predict_volume
        res = predict(model.predict_nhwc, volume, image_size=hw,
                      device=model.device)
        results[name] = res
        m = res["metrics"]
        print(
            f"{name}: SSIM {m['ssim_mean']:.4f}±{m['ssim_std']:.3f} "
            f"PSNR {m['psnr_mean']:.2f}±{m['psnr_std']:.2f} MAE {m['mae']:.4f}"
        )
        mp = res["metrics_predicted_only"]
        print(
            f"  predicted slices only: SSIM {mp['ssim_mean']:.4f} "
            f"PSNR {mp['psnr_mean']:.2f} MAE {mp['mae']:.4f}"
        )
        if args.export_dicom:
            from mrisr_tpu_torch.data.export import export_volume_dicom

            out_dir = export_volume_dicom(
                res["volume_predicted"],
                os.path.join(args.export_dicom, name),
                patient_id=f"seed{args.seed}",
                series_description=f"mrisr-tpu {name} predicted",
            )
            print(f"  DICOM series -> {out_dir}")
    if args.figure:
        if args.view == "parallel":
            path = figures.parallel_views_figure(
                results, f"seed{args.seed}", save_path=args.figure,
                sagittal_x=hw[1] // 2)
        else:
            # V8 single-view comparison (reference defaults X=128 / Z=30,
            # VolumeVisualization.py:1042-1271)
            path = figures.single_view_figure(
                results, view=args.view, index=args.view_index,
                patient_name=f"seed{args.seed}", save_path=args.figure)
        print(f"figure -> {path}")
    return results


def _compare_row_from_metrics(name: str, m: dict):
    """One model's test-metrics dict -> a (name, ssim3, psnr3, ssim6,
    psnr6) table row.  Pair and diffusion models carry '3mm'/'6mm' keys;
    the progressive model carries per-stage 'i1'/'i2'/'i3': i1 and i3
    predict across 3 mm gaps and i2 across 6 mm, the mapping of the
    reference README's Progressive row (`reference/README.md:129`).
    Missing stages or keys render as 'n/a' cells: ``--from-results``
    reads files written elsewhere."""
    def g(stage, key):
        v = m.get(stage)
        return v.get(key) if isinstance(v, dict) else None

    def avg(a, b):
        return (a + b) / 2 if a is not None and b is not None else None

    if "i1" in m and "i2" in m:
        return (name,
                avg(g("i1", "ssim_mean"), g("i3", "ssim_mean")),
                avg(g("i1", "psnr_mean"), g("i3", "psnr_mean")),
                g("i2", "ssim_mean"), g("i2", "psnr_mean"))
    return (name,
            g("3mm", "ssim_mean"), g("3mm", "psnr_mean"),
            g("6mm", "ssim_mean"), g("6mm", "psnr_mean"))


def cmd_compare(args) -> list:
    """Evaluate several models on the test split and print the README-style
    table (SSIM/PSNR per spacing, never aggregated) as markdown, and write
    it to ``<results_dir>/comparison_metrics.csv``.  ``--from-results``
    builds the table from the ``<model>_test_metrics.json`` files that
    ``eval`` writes instead of evaluating.  Returns the rows."""
    if args.from_results:
        rows = []
        results_dir = args.results_dir or "results"
        for name in args.model:
            path = os.path.join(results_dir, f"{name}_test_metrics.json")
            if not os.path.exists(path):
                print(f"skipping {name}: no {path}")
                continue
            with open(path) as f:
                rows.append(_compare_row_from_metrics(name, json.load(f)))
        _emit_compare_table(args, rows)
        return rows
    if not args.data:
        raise SystemExit("compare: --data is required unless --from-results")

    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.eval.runner import (
        evaluate_pair_model_test_set,
        evaluate_progressive_test_set,
    )

    store = VolumeStore.open(args.data)
    rows = []
    for name in args.model:
        model, cfg = _load_for(args, name)
        evaluate = (evaluate_progressive_test_set if model.kind == "window"
                    else evaluate_pair_model_test_set)
        m = evaluate(model.predict_nhwc, store, cfg.data,
                     mode=args.metric_mode, max_batches=args.max_batches,
                     backend=args.backend, device=model.device)
        rows.append(_compare_row_from_metrics(name, m))
    _emit_compare_table(args, rows)
    return rows


def _emit_compare_table(args, rows) -> None:
    import csv

    header = ("Model", "SSIM (3mm)", "PSNR (3mm)", "SSIM (6mm)", "PSNR (6mm)")
    print("| " + " | ".join(header) + " |")
    print("|" + "---|" * len(header))
    for r in rows:
        cells = [r[0]] + [
            ("n/a" if v is None else (f"{v:.4f}" if i in (0, 2) else f"{v:.2f}"))
            for i, v in enumerate(r[1:])
        ]
        print("| " + " | ".join(cells) + " |")
    results_dir = args.results_dir or "results"
    os.makedirs(results_dir, exist_ok=True)
    csv_path = os.path.join(results_dir, "comparison_metrics.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    print(f"csv -> {csv_path}")


def cmd_triplet_figure(args) -> dict:
    """V10: one seeded mid-volume triplet of a test-split volume, predicted
    by each pair model and drawn as PRE / POST / GT / predictions
    (`reference/src/VolumeVisualization.py:737-881`).  Returns the
    predictions by model."""
    import numpy as np
    import torch

    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.eval import figures
    from mrisr_tpu_torch.eval.volume_eval import normalize_volume

    figures.pyplot()  # before the predictions: no matplotlib, no run
    volume, rng = _test_volume(VolumeStore.open(args.data), args.seed)
    vol = normalize_volume(np.asarray(volume))
    z = vol.shape[0]
    if z < 7:
        print(f"volume has only {z} slices; need >= 7 for a mid-volume "
              "triplet", file=sys.stderr)
        sys.exit(1)
    # a seeded mid-volume triplet (the reference picks a random central one)
    i = rng.randrange(z // 4, 3 * z // 4 - 2)
    pre, gt, post = vol[i], vol[i + 1], vol[i + 2]
    preds = {}
    for name in args.model:
        model, _ = _load_for(args, name)
        if model.kind == "window":
            # the V10 grid is per triplet (2 in, 1 out); the reference's
            # figure has no progressive column either
            print(f"(skipping {name}: 5-slice-window models have no "
                  "single-triplet prediction)")
            continue
        x = torch.from_numpy(np.stack([pre, post], axis=-1)[None])
        preds[name] = model.predict_nhwc(x)[0, ..., 0].cpu().numpy()
    path = figures.triplet_grid_figure(pre, post, gt, preds,
                                       save_path=args.figure)
    print(f"figure -> {path}")
    return preds


def cmd_export_serving(args) -> None:
    """Export a checkpoint as a one-artifact serving bundle
    (``serve/bundle.py``): a pair UNet (quant int8_fused, int8 or none), or
    the fastddpm T-step sampler (quant none, int8 or int8_deep); the int8
    modes calibrate on ``--calib-batches`` batches of the val split."""
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.device import resolve_device
    from mrisr_tpu_torch.serve.bundle import export_serving_bundle

    cfg = _build_config(args, _preset_for(args.model))
    device = resolve_device(args.device)
    calib = None
    if args.quant != "none":
        loader = build_loader(VolumeStore.open(args.data), "val", cfg.data,
                              backend=args.backend, device=device)
        calib = []
        for i, batch in enumerate(loader):
            if i >= args.calib_batches:
                break
            calib.append(batch[..., :2])
    path = export_serving_bundle(
        args.out, model_name=args.model, models_dir=args.checkpoint_dir,
        quant=args.quant, calibration_batches=calib,
        percentile=args.percentile, cfg=cfg.model,
        image_size=cfg.data.image_size, device=device,
    )
    print(f"serving bundle -> {path}")


def cmd_serve(args) -> None:
    """Serve a bundle over HTTP (``serve/http.py``): .npy in, .npy out,
    the micro-batching engine on ``--device`` underneath."""
    from mrisr_tpu_torch.serve.http import serve_bundle

    server = serve_bundle(args.bundle, host=args.host, port=args.port,
                          batch_size=args.batch_size,
                          max_delay_ms=args.max_delay_ms, device=args.device)
    print(f"serving {args.bundle} on http://{server.host}:{server.port} "
          f"(batch {args.batch_size}; POST /predict, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
        server.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mrisr_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("extract")
    q.add_argument("zip")
    q.add_argument("out")
    q.set_defaults(fn=cmd_extract)

    q = sub.add_parser("clean")
    q.add_argument("root")
    q.add_argument("--yes", action="store_true")
    q.add_argument("--dry-run", action="store_true")
    q.set_defaults(fn=cmd_clean)

    q = sub.add_parser("pack")
    q.add_argument("root")
    q.add_argument("out")
    q.add_argument("--slices", type=int, default=60)
    q.set_defaults(fn=cmd_pack)

    q = sub.add_parser("synth")
    q.add_argument("out")
    q.add_argument("--patients", type=int, default=8)
    q.add_argument("--slices", type=int, default=60)
    q.add_argument("--size", type=int, default=256)
    q.add_argument("--seed", type=int, default=0,
                   help="base phantom seed (patient p uses seed+p)")
    q.set_defaults(fn=cmd_synth)

    q = sub.add_parser("train")
    q.add_argument("--preset", required=True, choices=sorted(PRESETS))
    q.add_argument("--config", default=None,
                   help="JSON config file overriding the preset "
                        "(mrisr_tpu/configs/*.json)")
    q.add_argument("--scan-epochs", action="store_true",
                   help="gather each train epoch's batches on the card "
                        "(requires --backend device)")
    _add_common_args(q)
    q.set_defaults(fn=cmd_train)

    q = sub.add_parser("distill")
    q.add_argument("--preset", default="unet_distilled",
                   choices=sorted(k for k in PRESETS
                                  if PRESETS[k].loss.kind == "distill"))
    q.add_argument("--teacher", default="unet",
                   help="trained pair-model checkpoint to distill from")
    q.add_argument("--teacher-dir", default=None,
                   help="teacher checkpoint dir (default: --checkpoint-dir)")
    q.add_argument("--teacher-features", type=int, default=None,
                   help="teacher base feature width if not the default 64")
    q.add_argument("--distill-alpha", type=float, default=None,
                   help="weight of the teacher-matching MSE term (1-alpha "
                        "weighs ground truth)")
    q.add_argument("--distill-lambda-ssim", type=float, default=None,
                   help="weight of an added (1 - SSIM(student, teacher)) "
                        "term (default 0: MSE only)")
    q.add_argument("--ema", type=float, default=None, metavar="DECAY",
                   help="average the student's parameters every step "
                        "(e.g. 0.999); eval and the _best checkpoint use "
                        "the averaged weights")
    q.add_argument("--teacher-quant", default="none",
                   choices=("none", "int8", "int8_fused"),
                   help="distill against the quantized teacher's outputs "
                        "(the serving numerics), calibrated on 4 val "
                        "batches")
    q.add_argument("--init-from-teacher", action="store_true",
                   help="initialize the student as a magnitude-pruned "
                        "channel slice of the teacher (BN |gamma| scores, "
                        "serve/prune.py)")
    q.add_argument("--config", default=None)
    q.add_argument("--scan-epochs", action="store_true")
    _add_common_args(q)
    q.set_defaults(fn=cmd_distill)

    q = sub.add_parser("distill-steps")
    q.add_argument("--teacher", default="fastddpm",
                   help="trained diffusion preset checkpoint to distill")
    q.add_argument("--teacher-dir", default=None,
                   help="teacher checkpoint dir (default: --checkpoint-dir)")
    q.add_argument("--factor", type=int, default=2,
                   help="teacher sub-steps folded into one student step a "
                        "round (the grid shrinks to ceil(N/factor))")
    q.add_argument("--rounds", type=int, default=2,
                   help="number of grid-shrink rounds (10 -> 5 -> 3)")
    q.add_argument("--no-eval", action="store_true",
                   help="skip the per-round test-set eval")
    q.add_argument("--max-eval-batches", type=int, default=None)
    q.add_argument("--config", default=None)
    _add_common_args(q)
    q.set_defaults(fn=cmd_distill_steps)

    q = sub.add_parser("serve")
    q.add_argument("--bundle", required=True,
                   help="serving bundle dir (see export-serving)")
    q.add_argument("--host", default="127.0.0.1")
    q.add_argument("--port", type=int, default=8000)
    q.add_argument("--batch-size", type=int, default=128)
    q.add_argument("--max-delay-ms", type=float, default=2.0)
    q.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    q.set_defaults(fn=cmd_serve)

    q = sub.add_parser("eval")
    q.add_argument("--model", required=True)
    q.add_argument("--metric-mode", default="minmax-each",
                   choices=("minmax-each", "denorm-11", "raw"))
    q.add_argument("--max-batches", type=int, default=None)
    _add_common_args(q)
    q.set_defaults(fn=cmd_eval)

    q = sub.add_parser("predict-volume")
    q.add_argument("--model", nargs="+", required=True)
    q.add_argument("--seed", type=int, default=42)
    q.add_argument("--hierarchical", action="store_true")
    q.add_argument("--figure", default=None,
                   help="draw the comparison figure here (needs "
                        "matplotlib)")
    q.add_argument("--view", default="parallel",
                   choices=("parallel", "sagittal", "axial"),
                   help="figure layout: 3-row parallel views (V7) or the "
                        "V8 single-view all-models row")
    q.add_argument("--view-index", type=int, default=None,
                   help="sagittal X / axial Z index (default: mid-volume; "
                        "reference used X=128 / Z=30)")
    q.add_argument("--export-dicom", default=None, metavar="DIR",
                   help="also write each model's predicted volume as a "
                        "DICOM series under DIR/<model>/ (data/export.py)")
    _add_common_args(q)
    q.set_defaults(fn=cmd_predict_volume)

    q = sub.add_parser("compare")
    q.add_argument("--model", nargs="+", required=True)
    q.add_argument("--metric-mode", default="minmax-each",
                   choices=("minmax-each", "denorm-11", "raw"))
    q.add_argument("--max-batches", type=int, default=None)
    q.add_argument("--from-results", action="store_true",
                   help="assemble the table from existing "
                        "<results_dir>/<model>_test_metrics.json artifacts "
                        "instead of evaluating live (no --data needed)")
    _add_common_args(q, data_required=False)
    q.set_defaults(fn=cmd_compare)

    q = sub.add_parser("triplet-figure")
    q.add_argument("--model", nargs="+", required=True)
    q.add_argument("--seed", type=int, default=42)
    q.add_argument("--figure", default="results/single_triplet.png")
    _add_common_args(q)
    q.set_defaults(fn=cmd_triplet_figure)

    q = sub.add_parser("export-serving")
    q.add_argument("--model", default="unet")
    q.add_argument("--out", required=True, help="bundle output directory")
    q.add_argument("--quant", default="int8_fused",
                   choices=("none", "int8", "int8_fused", "int8_deep"),
                   help="pair models: none/int8/int8_fused; "
                        "fastddpm: none/int8/int8_deep")
    q.add_argument("--calib-batches", type=int, default=4)
    q.add_argument("--percentile", type=float, default=None,
                   help="activation calibration |x| percentile "
                        "(default absmax)")
    _add_common_args(q)  # takes --allow-fresh; a bundle needs a checkpoint
    q.set_defaults(fn=cmd_export_serving)

    args = p.parse_args(argv)
    if hasattr(args, "mesh_data") and args.fn not in (cmd_train, cmd_distill):
        _check_mesh_flags(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
