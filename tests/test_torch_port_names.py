"""The port's public names held to mrisr_tpu's, by an AST scan of both
packages: every public top-level ``def`` and ``class`` of ``mrisr_tpu/``
has a same-named one in ``mrisr_tpu_torch/``, or a row in ``EXCEPTIONS``
that names its counterpart (a file of this repo and a name defined there)
and why the name differs; and the two CLIs have the same subcommands but
``bench``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# JAX name -> (file of the counterpart, its name, why the names differ);
# the file None: no counterpart yet, and the reason says what waits
EXCEPTIONS = {
    "ssim_pallas": (
        "mrisr_tpu_torch/ops/ssim_fused.py", "ssim_fused",
        "the Pallas entry of K1; the port's CUDA kernel csrc/ssim.cu"),
    "groupnorm_silu_pallas": (
        "mrisr_tpu_torch/ops/groupnorm.py", "groupnorm_silu",
        "the Pallas entry of K3; the port's CUDA kernel "
        "csrc/groupnorm_silu.cu"),
    "gn_pallas_eligible": (
        "mrisr_tpu_torch/ops/groupnorm.py", "plan",
        "the TPU's VMEM layout rule for K3; the card's tiling of it"),
    "restore_checkpoint": (
        "tools/orbax_to_torch.py", "convert",
        "reads an Orbax directory; the tool writes the .pt that the port's "
        "load_model reads"),
    "restore_checkpoint_numpy": (
        "tools/orbax_to_torch.py", "convert",
        "the host-numpy Orbax restore; the same tool"),
    "convert_torch_checkpoint": (
        "mrisr_tpu_torch/ckpt/torch_ckpt.py", "load_reference_state_dict",
        "turns a reference .pt into flax variables; the port loads it as "
        "it is"),
    "enable_compile_cache": (
        "mrisr_tpu_torch/_build.py", "build",
        "XLA's persistent compile cache; the port's kernels build once into "
        "directories named by a hash of their sources"),
    "cmd_bench": (
        None, None,
        "the bench subcommand comes with the port's benchmark"),
}
CLI_ONLY_IN_JAX = {"bench"}


def _public_names(root: Path) -> dict:
    """name -> files defining it as a public top-level def or class."""
    names = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                    and not node.name.startswith("_")):
                names.setdefault(node.name, []).append(
                    str(path.relative_to(ROOT)))
    return names


def _subcommands(cli: Path) -> set:
    """The names given to ``add_parser`` calls in a CLI module."""
    return {node.args[0].value for node in ast.walk(ast.parse(cli.read_text()))
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_parser"
            and node.args and isinstance(node.args[0], ast.Constant)}


JAX_NAMES = _public_names(ROOT / "mrisr_tpu")
PORT_NAMES = _public_names(ROOT / "mrisr_tpu_torch")


def test_every_jax_name_has_a_port_counterpart():
    missing = {name: files for name, files in JAX_NAMES.items()
               if name not in PORT_NAMES and name not in EXCEPTIONS}
    assert not missing, ("public names of mrisr_tpu with no counterpart in "
                         "mrisr_tpu_torch and no row in EXCEPTIONS: "
                         f"{missing}")


@pytest.mark.parametrize("name", sorted(EXCEPTIONS))
def test_exception_row_is_live(name):
    """The JAX name exists, the port has no same-named one (else the row
    is not needed), and the counterpart the row names is defined where it
    says."""
    path, counterpart, why = EXCEPTIONS[name]
    assert name in JAX_NAMES, f"{name} is gone from mrisr_tpu: drop its row"
    assert name not in PORT_NAMES, (
        f"{name} is in the port ({PORT_NAMES[name]}): drop its row")
    assert why
    if path is not None:
        tree = ast.parse((ROOT / path).read_text())
        defined = {n.name for n in tree.body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}
        assert counterpart in defined, f"{path} defines no {counterpart}"


def test_cli_subcommands_match_but_bench():
    jax_cmds = _subcommands(ROOT / "mrisr_tpu" / "cli.py")
    port_cmds = _subcommands(ROOT / "mrisr_tpu_torch" / "cli.py")
    assert CLI_ONLY_IN_JAX <= jax_cmds
    assert port_cmds == jax_cmds - CLI_ONLY_IN_JAX
