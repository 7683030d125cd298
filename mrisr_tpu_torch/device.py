"""Device selection and float-reference precision."""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: under a process group this rank's card,
    ``cuda:{LOCAL_RANK}`` (``parallel/mesh.py:local_rank``).  Without one
    this raises: an entry point never carries on quietly on the CPU, where
    only the plain versions run.  Pass ``device="cpu"`` to ask for those
    explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            from mrisr_tpu_torch.parallel.mesh import local_rank

            return torch.device("cuda", local_rank())
        return torch.device("cuda")
    return torch.device(device)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (the current one
    when it has no index): the kernels' plans size their grids by it."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return _sm_count(index)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@contextlib.contextmanager
def fp32_reference() -> Iterator[None]:
    """Full-float32 convolutions and matmuls inside the block.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits).  Calibration takes the absmax of every conv input from the
    float forward, and the int8 scales are fixed from it, so a TF32 drift
    would move every activation scale of the served model; the float
    reference that the int8 path is held against must be float32 too."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev

