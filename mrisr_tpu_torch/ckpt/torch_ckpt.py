"""The reference's torch checkpoint layout for every family.

The reference saves ``{'epoch', 'model_state_dict', 'val_loss', ...}``,
``{'generator_state_dict', ...}`` (GAN) or a raw state dict
(reference ``src/ModelLoader.py:693-705``).  Its UNet has the port's keys
(``enc1.conv.0.weight`` ...) except the 1x1 head, which the reference names
``final_conv`` in the MSE/combined UNet and ``final`` in the GAN generator
(``mrisr_tpu/ckpt/torch_convert.py:_convert_unet``); every other family
has the port's keys throughout (the simple Fast-DDPM's under ``unet.``).
BatchNorm's ``num_batches_tracked`` is not read by an eval forward; a state
dict that lacks it loads with zeros.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

# model name -> the reference's name of the UNet's 1x1 head
REFERENCE_HEAD = {"unet": "final_conv", "unet_combined": "final_conv",
                  "unet_distilled": "final_conv", "unet_gan": "final"}


def unwrap_state_dict(checkpoint: Any) -> Dict[str, torch.Tensor]:
    """The state dict inside any of the reference's three layouts."""
    if isinstance(checkpoint, dict):
        for key in ("generator_state_dict", "model_state_dict"):
            if key in checkpoint:
                return checkpoint[key]
    return checkpoint


def port_state_dict(checkpoint: Any) -> Dict[str, torch.Tensor]:
    """The state dict inside a reference-layout checkpoint (any of the
    three) under the port's names: the reference's simple Fast-DDPM files
    wrap the UNet2D's keys in ``unet.`` (dropped), and a pair UNet's head
    ``final_conv`` is the port's ``final``."""
    sd = unwrap_state_dict(checkpoint)
    if sd and all(k.startswith("unet.") for k in sd):
        sd = {k[len("unet."):]: v for k, v in sd.items()}
    return {("final." + k[len("final_conv."):] if k.startswith("final_conv.")
             else k): v for k, v in sd.items()}


def load_reference_state_dict(model: nn.Module, checkpoint: Any) -> None:
    """Load a reference-layout checkpoint (any of the three) into a port
    model, strictly (:func:`port_state_dict`'s names): every other missing
    or unexpected key raises."""
    sd = port_state_dict(checkpoint)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, torch.zeros_like(v))
    model.load_state_dict(sd, strict=True)


def _numpy_globals() -> List[Any]:
    """The numpy globals a pickled scalar, array or dtype names: the
    scalar and array rebuilders under both module paths (numpy 1 pickles
    ``numpy.core.multiarray``, numpy 2 ``numpy._core.multiarray``),
    ``ndarray``, ``dtype`` and every concrete dtype class."""
    try:
        from numpy._core import multiarray
    except ImportError:  # numpy 1
        from numpy.core import multiarray
    out: List[Any] = [np.ndarray, np.dtype]
    out += [getattr(np.dtypes, n) for n in dir(np.dtypes)
            if n.endswith("DType")]
    for name in ("scalar", "_reconstruct"):
        fn = getattr(multiarray, name)
        out.append(fn)
        out += [(fn, f"{m}.{name}") for m in ("numpy.core.multiarray",
                                              "numpy._core.multiarray")
                if m != fn.__module__]
    return out


def load_checkpoint_file(path: str) -> Any:
    """``torch.load`` of a checkpoint file onto the CPU, weights-only.

    A reference-layout dict may carry numpy values beside the state dict
    (``val_loss=np.float64(...)``, a history array, a list of
    ``np.float32``), which the plain weights-only unpickler refuses; the
    load is then retried with numpy's scalar, array and dtype globals
    allowlisted.  It stays weights-only: no other global is admitted."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        with torch.serialization.safe_globals(_numpy_globals()):
            return torch.load(path, map_location="cpu", weights_only=True)


def reference_checkpoint(model: nn.Module, model_name: str, epoch: int = 0,
                         val_loss: float = 0.0) -> Dict[str, Any]:
    """A port model as the reference saves it:
    ``{'epoch', 'model_state_dict', 'val_loss'}``, a pair UNet's head under
    the reference's name."""
    return {"epoch": int(epoch),
            "model_state_dict": reference_state_dict(model.state_dict(),
                                                     model_name),
            "val_loss": float(val_loss)}


def reference_state_dict(sd: Dict[str, torch.Tensor], model_name: str
                         ) -> Dict[str, torch.Tensor]:
    """A port state dict (or any part of one) under the reference's names,
    detached on the CPU: a pair UNet's head is ``final_conv`` (``final``
    in the GAN generator)."""
    head = REFERENCE_HEAD.get(model_name, "final")
    return {(head + k[len("final"):] if k.startswith("final.") else k):
            v.detach().cpu() for k, v in sd.items()}


def orbax_record(directory: str) -> Dict[str, Any]:
    """What the conversion ``<directory>.pt`` of an Orbax checkpoint
    records (``tools/orbax_to_torch.py``): the directory's name and the
    sha256 of its ``_CHECKPOINT_METADATA``, which Orbax rewrites with the
    commit time at every save (None where the file is missing).  A
    re-saved checkpoint changes it, so a stale conversion, or another file
    of that name, does not match."""
    path = os.path.join(directory, "_CHECKPOINT_METADATA")
    digest = None
    if os.path.isfile(path):
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    return {"dir": os.path.basename(os.path.normpath(directory)),
            "sha256": digest}
