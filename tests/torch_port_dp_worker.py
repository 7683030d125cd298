"""One rank of the port's two-rank data-parallel checks (CPU, gloo).

``tests/test_torch_port_parallel.py`` starts two of these for all its
cases at once:

    python tests/torch_port_dp_worker.py RANK WORLD PORT CLI_PORTS IN OUT

(CLI_PORTS: one free port a CLI run, comma-separated.)

IN holds the cases' inputs (``torch.save``), OUT the rank's results.  The
same :func:`run_case` runs unmeshed in the test process, on the same
inputs, as the single-process reference.  An IN with a ``cases`` list
runs those cases and its CLI runs only (``tests/test_torch_port_remat.py``
takes ``supervised_remat``, the supervised step with ``UNet(remat=True)``).
This module imports torch and the port only, no JAX.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mrisr_tpu_torch.config import PRESETS, ModelConfig  # noqa: E402
from mrisr_tpu_torch.losses import mse  # noqa: E402
from mrisr_tpu_torch.models.registry import init_model  # noqa: E402
from mrisr_tpu_torch.parallel.mesh import (  # noqa: E402
    replicated,
    shard_batch,
)
from mrisr_tpu_torch.train.state import create_train_state  # noqa: E402

FEAT = 4
CASES = ("supervised", "gan", "progressive", "diffusion", "distill")


def _state(module, tcfg, mesh, lr=None):
    state = create_train_state(module, tcfg, learning_rate=lr)
    if mesh is not None:
        replicated(module, mesh)
        state.mesh = mesh
    return state


def _local(batch, mesh):
    return batch if mesh is None else shard_batch(batch, mesh)


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _stats(module):
    return {n: b.detach().clone() for n, b in module.named_buffers()
            if "running" in n}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def run_case(name, inputs, mesh=None):
    """One case's steps on the global batches of ``inputs[name]``, each
    rank on its rows when ``mesh`` is given; returns the metrics (train
    and eval, a list a step), and the first step's gradients and BatchNorm
    running statistics (the second step's inputs are the updated weights,
    which Adam's sqrt(v) + eps moves by about lr either way where a
    gradient is rounding noise)."""
    from mrisr_tpu_torch.train.steps import (
        make_diffusion_steps,
        make_gan_steps,
        make_progressive_steps,
        make_supervised_steps,
    )

    inp = inputs["supervised" if name == "supervised_remat" else name]
    batches = [_local(b, mesh) for b in inp["batches"]]
    out = {"train": [], "eval": []}
    if name in ("supervised", "supervised_remat"):
        from mrisr_tpu_torch.models import UNet

        module = UNet(features=FEAT, remat=name == "supervised_remat")
        module.load_state_dict(inp["state_dict"])
        state = _state(module, PRESETS["unet"].train, mesh)
        train_step, eval_step = make_supervised_steps(
            lambda p, t: (mse(p, t), {}))
        for b in batches:
            _, m = train_step(state, b)
            out["train"].append(_floats(m))
            out.setdefault("grads", _grads(module))
            out.setdefault("stats", _stats(module))
    elif name == "gan":
        cfg = ModelConfig(name="unet_gan", base_features=FEAT)
        gen, _ = init_model("unet_gan", cfg, seed=0)
        disc, _ = init_model("patchgan", cfg, seed=1)
        tcfg = PRESETS["unet_gan"].train
        g_state = _state(gen, tcfg, mesh)
        d_state = _state(disc, tcfg, mesh, lr=tcfg.learning_rate_d)
        train_step, eval_step = make_gan_steps()
        for b in batches:
            _, _, m = train_step(g_state, d_state, b)
            out["train"].append(_floats(m))
            out["eval"].append(_floats(eval_step(g_state, d_state, b)))
            out.setdefault("stats", {**_stats(gen), **{
                f"d.{k}": v for k, v in _stats(disc).items()}})
    elif name == "progressive":
        from mrisr_tpu_torch.losses import progressive_loss

        cfg = ModelConfig(name="progressive_unet", base_features=FEAT)
        module, _ = init_model("progressive_unet", cfg, seed=0)
        state = _state(module, PRESETS["progressive_unet"].train, mesh)
        train_step, eval_step = make_progressive_steps(
            lambda preds, w: progressive_loss(preds, w))
        for b in batches:
            _, m = train_step(state, b)
            out["train"].append(_floats(m))
            out["eval"].append(_floats(eval_step(state, b)))
            out.setdefault("stats", _stats(module))
    elif name == "diffusion":
        from mrisr_tpu_torch.models.diffusion import (
            DiffusionSchedule,
            FastDDPMUNet,
        )

        module = FastDDPMUNet(base_features=FEAT, time_dim=8)
        module.load_state_dict(inp["state_dict"])
        state = _state(module, PRESETS["fastddpm"].train, mesh)
        train_step, eval_step = make_diffusion_steps(
            DiffusionSchedule.create(num_timesteps=1000,
                                     num_inference_steps=10))
        gen = torch.Generator().manual_seed(7)
        for b in batches:
            _, m = train_step(state, b, gen)
            out["train"].append(_floats(m))
            out.setdefault("grads", _grads(module))
        # validation is not sharded (every rank scores the whole batch)
        out["eval"].append(_floats(eval_step(
            state, inp["batches"][0], torch.Generator().manual_seed(8))))
    elif name == "distill":
        from mrisr_tpu_torch.serve.distill import make_distill_steps
        from mrisr_tpu_torch.serve.quant import Int8FusedUNet

        teacher = Int8FusedUNet(inp["qparams"], device="cpu")
        cfg = ModelConfig(name="unet_distilled", base_features=2)
        module, _ = init_model("unet_distilled", cfg, seed=0)
        state = _state(module, PRESETS["unet_distilled"].train, mesh)
        state.seed_ema()
        train_step, eval_step = make_distill_steps(
            lambda x: teacher(x).float(), alpha=0.5, lambda_ssim=0.1,
            ema_decay=0.9)
        for b in batches:
            _, m = train_step(state, b)
            out["train"].append(_floats(m))
            out.setdefault("grads", _grads(module))
            out.setdefault("stats", _stats(module))
        out["ema"] = {k: v.clone() for k, v in state.ema_params.items()}
    else:
        raise ValueError(name)
    return out


def _cli_train(args, out, key):
    from mrisr_tpu_torch import cli

    tr = cli.main(args)
    out[key] = None if tr is None else {
        k: list(v) for k, v in tr.history.series.items()}


def _collectives_loader_rules(inputs, mesh, world, rank):
    """The collectives, the sharded loader and the CLI's mesh rules at
    this world size."""
    import contextlib
    import io

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.config import Config, DataConfig, MeshConfig
    from mrisr_tpu_torch.data.pipeline import (
        build_loader,
        host_shard_patients,
    )
    from mrisr_tpu_torch.data.volumes import VolumeStore
    from mrisr_tpu_torch.parallel.mesh import (
        MeshSpec,
        all_gather_batch,
        batch_sharding,
        make_mesh,
        psum,
        psum_mean,
    )

    out = {}
    # distributed_init for real: a cross-process sum, the mean, the
    # gathered batch (and its gradient), the patient shards
    local = torch.full((1, 4), float(rank + 1))
    x = torch.arange(4.0 * world).reshape(world * 2, 2)[
        mesh.rows(world * 2)].requires_grad_(True)
    gathered = all_gather_batch(x, mesh)
    (gathered * torch.arange(gathered.numel(), dtype=torch.float32)
     .reshape(gathered.shape)).sum().backward()
    out["collectives"] = {
        "sum": float(psum(local, mesh).sum()),
        "mean": float(psum_mean(torch.tensor(float(rank)), mesh)),
        "gathered": gathered.detach().numpy(), "gather_grad": x.grad.numpy(),
        "shard": host_shard_patients([f"p{i}" for i in range(5)]),
        "mesh": mesh.shape, "rank": mesh.rank}

    # the loader's rows of each global batch, and the CLI's mesh rules
    store_dir = inputs["store"]
    store = VolumeStore.open(store_dir)
    dcfg = DataConfig(root=store_dir, batch_size=4, image_size=(16, 16),
                      augment=True, prefetch=0)
    loader = build_loader(store, "train", dcfg, device="cpu",
                          sharding=batch_sharding(mesh))
    out["loader"] = [b.numpy() for b, _ in zip(loader, range(3))]
    rules = {}
    for label, data, batch in (("explicit 2", 2, 4), ("too many", 4, 4),
                               ("indivisible", 2, 3), ("auto", -1, 4),
                               ("auto shrunk", -1, 3)):
        cfg = Config(data=DataConfig(batch_size=batch),
                     mesh=MeshConfig(data=data))
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                m = cli._training_mesh(cfg, torch.device("cpu"))
            rules[label] = ("mesh", None if m is None else m.shape,
                            printed.getvalue())
        except SystemExit as e:
            rules[label] = ("exit", str(e), printed.getvalue())
    try:
        make_mesh(MeshSpec(data=1), devices=[0, 1], device="cpu")
    except AssertionError as e:
        rules["make_mesh 1x1 over 2"] = ("assert", str(e), "")
    out["rules"] = rules
    return out


def main(argv):
    import torch.distributed as dist

    from mrisr_tpu_torch.parallel.mesh import distributed_init, make_mesh

    rank, world, port = (int(a) for a in argv[:3])
    cli_ports = [int(p) for p in argv[3].split(",")]
    in_path, out_dir = argv[4], argv[5]
    torch.set_num_threads(2)
    distributed_init(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    inputs = torch.load(in_path, weights_only=False)
    cases = inputs.get("cases", CASES)
    out = {name: run_case(name, inputs, mesh) for name in cases}
    if "cases" not in inputs:
        out.update(_collectives_loader_rules(inputs, mesh, world, rank))
    dist.destroy_process_group()

    # the CLI as torchrun starts it: the group from the environment, once
    # a run of IN's "cli" (--mesh-data WORLD unless the run names a mesh)
    os.environ.update(MASTER_ADDR="localhost", WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    for cli_port, (key, extra) in zip(cli_ports, inputs["cli"].items()):
        os.environ["MASTER_PORT"] = str(cli_port)
        mesh_args = ([] if any(a.startswith("--mesh-") for a in extra)
                     else ["--mesh-data", str(world)])
        _cli_train([*inputs["cli_common"], "--checkpoint-dir",
                    os.path.join(out_dir, f"{key}_models"),
                    "--results-dir", os.path.join(out_dir, f"{key}_results"),
                    *mesh_args, *extra], out, key)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
