"""The port's public names held to mrisr_tpu's, by an AST scan of both
packages: every public top-level ``def`` and ``class`` of ``mrisr_tpu/``
has a same-named one in ``mrisr_tpu_torch/``, or a row in ``EXCEPTIONS``
that names its counterpart (a file of this repo and a name defined there)
and why the name differs; every public method of a JAX class has a
same-named one on the port's class of that name (bases included), or a
row in ``METHOD_EXCEPTIONS``; every field of ``mrisr_tpu/config.py``'s
dataclasses is read somewhere in the port outside its ``config.py``, or
has a row in ``CONFIG_EXCEPTIONS`` saying why not; and the two CLIs have
the same subcommands but ``bench``."""

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
# "Class.method" of mrisr_tpu -> why the port's class of that name has no
# method of that name
METHOD_EXCEPTIONS = {}
# config field of mrisr_tpu/config.py -> why the port never reads it
CONFIG_EXCEPTIONS = {
    "donate_batch": (
        "jax.jit buffer donation of the train step's batch "
        "(mrisr_tpu/train/steps.py); torch has no donation: a batch's "
        "memory is freed when its last reference goes"),
}


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


def _classes(root: Path) -> dict:
    """class name -> [(its public methods, its bases' names)], one entry a
    definition, for every top-level class of the package."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, ast.ClassDef):
                continue
            methods = {m.name for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and not m.name.startswith("_")}
            bases = [b.id if isinstance(b, ast.Name) else b.attr
                     for b in node.bases
                     if isinstance(b, (ast.Name, ast.Attribute))]
            out.setdefault(node.name, []).append((methods, bases))
    return out


def _methods(classes: dict, name: str, seen=()) -> set:
    """The public methods of class ``name``, those of its bases defined in
    the same package included."""
    out = set()
    for methods, bases in classes.get(name, ()):
        out |= methods
        for base in bases:
            if base not in seen:
                out |= _methods(classes, base, seen + (name,))
    return out


def _config_fields() -> dict:
    """field -> the dataclasses of mrisr_tpu/config.py declaring it."""
    fields = {}
    tree = ast.parse((ROOT / "mrisr_tpu" / "config.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and any(
                "dataclass" in ast.unparse(d) for d in node.decorator_list):
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    fields.setdefault(stmt.target.id, []).append(node.name)
    return fields


def _port_reads() -> set:
    """Every attribute the port reads off an object other than ``self``
    (a module's own attribute of the same name is not a config read) and
    every string constant it holds (a ``getattr`` name or a dict key),
    outside ``mrisr_tpu_torch/config.py``, where the fields are declared."""
    reads = set()
    port = ROOT / "mrisr_tpu_torch"
    for path in sorted(port.rglob("*.py")):
        if path == port / "config.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and not (isinstance(node.value, ast.Name)
                             and node.value.id == "self")):
                reads.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                reads.add(node.value)
    return reads


JAX_NAMES = _public_names(ROOT / "mrisr_tpu")
PORT_NAMES = _public_names(ROOT / "mrisr_tpu_torch")
JAX_CLASSES = _classes(ROOT / "mrisr_tpu")
PORT_CLASSES = _classes(ROOT / "mrisr_tpu_torch")
CONFIG_FIELDS = _config_fields()


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


def test_every_jax_method_has_a_port_counterpart():
    """A public class of both packages: each public method of the JAX
    class (its bases' too) is on the port's class, or has a row."""
    missing = {}
    for name in JAX_CLASSES:
        if name.startswith("_") or name not in PORT_CLASSES:
            continue
        gone = {m for m in _methods(JAX_CLASSES, name) - _methods(
            PORT_CLASSES, name) if f"{name}.{m}" not in METHOD_EXCEPTIONS}
        if gone:
            missing[name] = sorted(gone)
    assert not missing, ("public methods of mrisr_tpu classes missing on "
                         "the port's class and with no row in "
                         f"METHOD_EXCEPTIONS: {missing}")


def test_every_config_field_is_read_by_the_port():
    """Each field of the JAX config's dataclasses is read in the port (an
    attribute load, or its name as a string: ``getattr``, a JSON key),
    outside the port's own ``config.py``, or has a row saying why not."""
    reads = _port_reads()
    unread = {field: owners for field, owners in CONFIG_FIELDS.items()
              if field not in reads and field not in CONFIG_EXCEPTIONS}
    assert not unread, ("mrisr_tpu config fields that the port declares "
                        "but never reads, with no row in CONFIG_EXCEPTIONS: "
                        f"{unread}")


@pytest.mark.parametrize("row", [f"method:{k}" for k in sorted(
    METHOD_EXCEPTIONS)] + [f"config:{k}" for k in sorted(CONFIG_EXCEPTIONS)])
def test_method_and_config_rows_are_live(row):
    """A row's method or field is in mrisr_tpu, the port still lacks it
    (else the row is not needed), and the row says why."""
    table, key = row.split(":")
    if table == "method":
        cls, method = key.split(".")
        assert method in _methods(JAX_CLASSES, cls), f"{key} is gone"
        assert method not in _methods(PORT_CLASSES, cls), (
            f"{key} is in the port: drop its row")
        assert METHOD_EXCEPTIONS[key]
    else:
        assert key in CONFIG_FIELDS, f"{key} is gone: drop its row"
        assert key not in _port_reads(), (
            f"{key} is read by the port: drop its row")
        assert CONFIG_EXCEPTIONS[key]
