"""Checkpoint files of the trainers (counterpart: ``mrisr_tpu/ckpt/io.py``,
which writes Orbax directories).

One ``torch.save`` file a checkpoint, ``<prefix>_best.pt``,
``<prefix>_latest.pt`` and ``<prefix>_epoch_<N>.pt``, every tensor on the
CPU.  A file is written to a temporary name and renamed, so a reader never
sees half of one.  An asynchronous save copies the tensors to the CPU before
it returns (training goes on mutating the originals) and leaves the write to
one background thread; :func:`wait_for_async_saves` waits for every write
queued so far and raises the first that failed (it also runs at exit).
"""

from __future__ import annotations

import atexit
import os
import queue
import re
import threading
from typing import Any, Optional, Tuple

import torch


def _to_cpu(obj: Any, copy: bool) -> Any:
    """``obj`` with every tensor on the CPU, detached; ``copy`` also copies
    tensors that are there already."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.to("cpu", copy=True) if copy else t.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v, copy) for v in obj)
    return obj


def _write(path: str, obj: Any) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class _AsyncWriter:
    """One background thread writing queued checkpoints in order."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        threading.Thread(target=self._run, daemon=True,
                         name="checkpoint-writer").start()

    def _run(self) -> None:
        while True:
            path, obj = self._q.get()
            try:
                _write(path, obj)
            except BaseException as e:  # raised by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, path: str, obj: Any) -> None:
        self._q.put((path, obj))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors.pop(0)


_writer: Optional[_AsyncWriter] = None
_writer_lock = threading.Lock()


def _async_writer() -> _AsyncWriter:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = _AsyncWriter()
            atexit.register(_writer.wait)
        return _writer


def save_checkpoint(path: str, state: Any, async_: bool = False) -> None:
    """Save a nest of dicts, lists, tensors and Python scalars to ``path``;
    ``async_=True`` returns once the tensors are copied to the CPU."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if async_:
        _async_writer().submit(path, _to_cpu(state, copy=True))
    else:
        _write(path, _to_cpu(state, copy=False))


def wait_for_async_saves() -> None:
    if _writer is not None:
        _writer.wait()


def get_latest_checkpoint(checkpoint_dir: str, prefix: str
                          ) -> Optional[Tuple[str, int]]:
    """The ``<prefix>_epoch_<N>.pt`` with the highest N, as (path, N)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    pat = re.compile(re.escape(prefix) + r"_epoch_(\d+)\.pt$")
    best = None
    for name in os.listdir(checkpoint_dir):
        m = pat.match(name)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (os.path.join(checkpoint_dir, name), int(m.group(1)))
    return best
