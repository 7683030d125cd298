"""One rank of the port's four-rank 'model'-axis checks (CPU, gloo).

``tests/test_torch_port_tp.py`` starts four of these for all its cases at
once:

    python tests/torch_port_tp_worker.py RANK WORLD PORT CLI_PORTS IN OUT

(CLI_PORTS: one free port a CLI run, comma-separated.)

IN holds the inputs (``torch.save``), OUT the rank's results.  The rank
runs each family's forward under ``shard_module`` on a 1 x 2 mesh (ranks 0
and 1; ranks 2 and 3 sit it out) and a 2 x 2 mesh (all four), the CLI's
``_training_mesh`` rules at world size 4, and the CLI runs of IN as
torchrun starts them (the process group from the environment).  This
module imports torch and the port only, no JAX.
"""

import contextlib
import io
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mrisr_tpu_torch.config import ModelConfig  # noqa: E402
from mrisr_tpu_torch.models.registry import create_model  # noqa: E402
from mrisr_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_batch,
    param_shardings,
    shard_batch,
    shard_module,
)

MIN_SIZE = 1024  # tests/test_distributed.py's tensor-parallel threshold


def build(name: str, feat: int, state_dict) -> torch.nn.Module:
    module = create_model(name, ModelConfig(name=name, base_features=feat))
    module.load_state_dict(state_dict)
    return module.eval()


@torch.no_grad()
def forward(name: str, module, inputs, mesh=None):
    """The family's eval forward on ``inputs`` (x, and t for the
    diffusion UNet); under ``mesh``, on the rows of this rank's data
    coordinate, gathered back to the global batch.  A tuple for the
    progressive UNet."""
    local = [t if mesh is None else shard_batch(t, mesh) for t in inputs]
    out = module(*local)
    outs = out if isinstance(out, tuple) else (out,)
    if mesh is not None:
        outs = tuple(all_gather_batch(o.contiguous(), mesh) for o in outs)
    return outs if isinstance(out, tuple) else outs[0]


def sharded_forward(name, spec, mesh):
    """A family's forward with its parameters sharded over ``mesh``'s
    model group; returns the output and the parameters this rank holds."""
    module = build(name, spec["feat"], spec["state_dict"])
    shard_module(module, mesh, param_shardings(module, mesh, MIN_SIZE))
    held = sum(p.numel() for p in module.parameters())
    return {"y": forward(name, module, spec["inputs"], mesh), "held": held}


def mesh_info(mesh):
    return {"shape": mesh.shape, "rank": mesh.rank, "ranks": mesh.ranks,
            "model_rank": mesh.model_rank, "model_ranks": mesh.model_ranks,
            "member": mesh.member, "first": mesh.first}


def main(argv):
    import torch.distributed as dist

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.config import Config, DataConfig, MeshConfig
    from mrisr_tpu_torch.parallel.mesh import (
        MeshSpec,
        distributed_init,
        make_mesh,
    )

    rank, world, port = (int(a) for a in argv[:3])
    cli_ports = [int(p) for p in argv[3].split(",")]
    in_path, out_dir = argv[4], argv[5]
    torch.set_num_threads(1)
    distributed_init(f"localhost:{port}", world, rank, backend="gloo")
    inputs = torch.load(in_path, weights_only=False)
    meshes = {"1x2": make_mesh(MeshSpec(data=1, model=2), devices=[0, 1],
                               device="cpu"),
              "2x2": make_mesh(MeshSpec(data=2, model=2), device="cpu")}
    out = {"mesh": {k: mesh_info(m) for k, m in meshes.items()},
           "forward": {}}
    for name, spec in inputs["families"].items():
        for label, mesh in meshes.items():
            if not mesh.member:
                continue
            out["forward"][name, label] = sharded_forward(name, spec, mesh)
    # a full-size barrier over both groups of the 2 x 2 mesh
    meshes["2x2"].barrier()

    # the CLI's mesh rules at world size 4
    rules = {}
    for label, data, model, batch in inputs["rules"]:
        cfg = Config(data=DataConfig(batch_size=batch),
                     mesh=MeshConfig(data=data, model=model))
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                m = cli._training_mesh(cfg, torch.device("cpu"))
            rules[label] = ("mesh", None if m is None else m.shape,
                            None if m is None else m.member)
        except (SystemExit, AssertionError) as e:
            rules[label] = (type(e).__name__, str(e), None)
    out["rules"] = rules
    dist.destroy_process_group()

    # the CLI as torchrun starts it: the group from the environment
    os.environ.update(MASTER_ADDR="localhost", WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    out["cli"] = {}
    for cli_port, (key, args) in zip(cli_ports, inputs["cli"].items()):
        os.environ["MASTER_PORT"] = str(cli_port)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            tr = cli.main([*args, "--checkpoint-dir",
                           os.path.join(out_dir, f"{key}_models"),
                           "--results-dir",
                           os.path.join(out_dir, f"{key}_results")])
        out["cli"][key] = {
            "history": None if tr is None else {
                k: list(v) for k, v in tr.history.series.items()},
            "writes": None if tr is None else tr._writes,
            "stdout": printed.getvalue()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
