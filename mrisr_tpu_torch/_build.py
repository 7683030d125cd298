"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/kernels/`` at the repo root
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built
when a module is imported: the first launch builds what it needs, and
:func:`build` starts all compilers at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("conv_int8", "upconv_int8", "ssim", "groupnorm_silu",
           "quantize_int8", "bias_residual", "layernorm_modulate")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the launchers (each returns cudaGetLastError()) and of
# their int-valued helpers
SIGNATURES = {
    "conv_int8_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P],
    "upconv_int8_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P],
    "ssim_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "ssim_blocks_per_sm": [_I],
    "groupnorm_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "quantize_int8_launch": [_P, _I, _P, _P, _L, _I, _P],
    "bias_residual_launch": [_P, _I, _P, _P, _P, _L, _I, _I, _P],
    "gated_residual_launch": [_P, _I, _P, _L, _P, _L, _I, _I, _I, _P],
    "layernorm_modulate_launch": [_P, _I, _P, _L, _P, _P, _I, _I, _I, _D,
                                  _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (sm_90a) to build")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes in parallel.  Returns ``{name: (seconds, compiler output)}``
    for what was compiled; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # unique per process and thread: two first launches may race here
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


# the CUDA runtime's codes a launcher is expected to return, and launcher
# codes past the runtime's (csrc/wgmma_int8.cuh, tc::ERR_*)
_LAUNCHER_ERRORS = {
    720: "the cooperative grid cannot be co-resident on the device "
         "(cudaErrorCooperativeLaunchTooLarge)",
    10001: "cuTensorMapEncodeTiled refused a tensor map",
    10002: "the driver has no cuTensorMapEncodeTiled",
}


def check(err: int, what: str) -> None:
    """Raise on a launcher's cudaGetLastError() code."""
    if err != 0:
        why = _LAUNCHER_ERRORS.get(err, "CUDA launch failed")
        raise RuntimeError(f"{what}: {why} (error {err})")
