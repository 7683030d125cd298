#!/usr/bin/env python3
"""Convert the JAX package's Orbax checkpoints to the port's torch layout.

    python tools/orbax_to_torch.py models/unet_best [models/deepcnn_best ...]
    python tools/orbax_to_torch.py runs/exp42 --model unet
    python tools/orbax_to_torch.py --models-dir models

Every JAX trainer writes Orbax directories (``<name>_best``,
``<name>_latest``, ``<name>_epoch_N``).  For each directory ``D`` this
restores it as ``mrisr_tpu/api.py:_load_orbax`` does (the generator's
subtree of a GAN checkpoint, then its params and batch_stats), converts the
variables with the family's converter in ``mrisr_tpu_torch/ckpt/
from_jax.py`` and writes ``D.pt`` in the reference's layout
(``{'model_state_dict': ...}``, a pair UNet's head as ``final_conv``),
recording ``D``'s name and the hash of its metadata file
(``ckpt/torch_ckpt.py:orbax_record``).  The port's ``load_model`` then
reads ``D.pt`` wherever the JAX package would read ``D``, and refuses a
``D.pt`` whose record does not match ``D``.

``--models-dir M`` converts every ``*_best`` directory in ``M``, the
step-distilled students' ``<teacher>_steps<N>_best`` among them (their
``_grid.json`` sidecars already sit beside them).  The family comes from
``--model``, the name ``load_model`` is called with, or else from the
directory's name: ``unet*`` (the GAN's generator and the distilled
student too), ``progressive*``, ``deepcnn``, ``fastddpm_simple``, other
``fastddpm*``.  A directory without Orbax's ``_CHECKPOINT_METADATA`` is
refused: its conversion could not be told from a stale one.  Needs JAX
and Orbax (the port needs neither), and runs JAX on the CPU.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def model_name(directory: str) -> str:
    """``<name>_best`` / ``_latest`` / ``_epoch_N`` -> ``<name>``."""
    base = os.path.basename(os.path.normpath(directory))
    return re.sub(r"_(best|latest|epoch_\d+)$", "", base)


def converter(name: str):
    """The ``ckpt/from_jax.py`` converter of model ``name``'s family (a
    step-distilled student's is its teacher's)."""
    from mrisr_tpu_torch.ckpt import from_jax

    family = re.sub(r"_steps\d+$", "", name)
    if family.startswith("unet"):
        return from_jax.unet_state_dict_from_flax
    if family.startswith("progressive"):
        return from_jax.progressive_state_dict_from_flax
    if family == "deepcnn":
        return from_jax.deepcnn_state_dict_from_flax
    if family == "fastddpm_simple":
        return from_jax.simple_diffusion_state_dict_from_flax
    if family.startswith("fastddpm"):
        return from_jax.fastddpm_state_dict_from_flax
    raise ValueError(f"{name}: no converter for this family (unet*, "
                     "progressive*, deepcnn, fastddpm*); name the model "
                     "with --model")


def convert(directory: str, name: str | None = None) -> str:
    """Convert the Orbax checkpoint ``directory`` of model ``name`` (None:
    the directory's name says); returns the path written,
    ``<directory>.pt``."""
    import jax
    import numpy as np
    import torch

    from mrisr_tpu.api import _load_orbax
    from mrisr_tpu_torch.ckpt.torch_ckpt import (
        orbax_record,
        reference_state_dict,
    )

    directory = os.path.normpath(directory)
    name = name or model_name(directory)
    convert_fn = converter(name)
    record = orbax_record(directory)
    if record["sha256"] is None:
        raise ValueError(f"{directory} has no _CHECKPOINT_METADATA: not an "
                         "Orbax checkpoint this tool can record")
    variables = jax.tree.map(np.asarray, _load_orbax(directory, None))
    state_dict = convert_fn(variables)
    out = directory + ".pt"
    torch.save({"model_state_dict": reference_state_dict(state_dict, name),
                "orbax": record}, out)
    return out


def best_dirs(models_dir: str):
    """Every ``*_best`` Orbax directory in ``models_dir``, sorted."""
    return sorted(os.path.join(models_dir, d) for d in os.listdir(models_dir)
                  if d.endswith("_best")
                  and os.path.isdir(os.path.join(models_dir, d)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="Orbax checkpoint directories")
    ap.add_argument("--model", help="the load_model name of the "
                    "directories given (default: each directory's name)")
    ap.add_argument("--models-dir", help="convert every *_best in it")
    args = ap.parse_args(argv)
    dirs = [(d, args.model) for d in args.dirs]
    if args.models_dir:
        dirs += [(d, None) for d in best_dirs(args.models_dir)]
    if not dirs:
        ap.error("give Orbax directories or --models-dir")
    import jax

    jax.config.update("jax_platforms", "cpu")
    for d, name in dirs:
        print(f"{d} -> {convert(d, name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
