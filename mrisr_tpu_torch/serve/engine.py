"""Micro-batching inference engine (counterpart: ``mrisr_tpu/serve/engine.py``).

Callers submit single ``(H, W, 2)`` numpy requests from any thread and get
a ``Future`` of ``(H, W, 1)``.  One dispatcher thread drains the queue into
a static batch (wrap-padding a partial one, so every dispatch has the same
shape), waits at most ``max_delay_ms`` for stragglers once a batch has its
first request, and keeps ONE batch in flight: the host assembles batch N+1
while the card computes batch N.

On the card: two pinned host input buffers (ping-pong), a dedicated CUDA
stream, a ``non_blocking`` host-to-device copy, and the result copied back
into a pinned buffer behind an event; resolving a batch waits on that event
(``EngineStats.sync_wait_s``) and copies the rows out of the pinned buffer
(``EngineStats.copy_out_s``).

Each phase of the dispatcher is a span (``utils/profiling.py:span``) with
the batch's ordinal as its id: ``engine.wait_first``, ``engine.collect``,
``engine.pad``, ``engine.dispatch``, ``engine.sync``, ``engine.copy_out``
and ``engine.resolve``.  They record only while a ``torch.profiler``
records; the counters of ``EngineStats`` are always on.

:func:`engine_from_model` builds an engine from a checkpoint, as the
reference's does: the BN-folded float forward over bf16-rounded weights
(quant 'none'), or the int8 forward calibrated on the caller's batches
(quant 'int8' or 'int8_fused').
"""

from __future__ import annotations

import copy
import functools
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.utils.profiling import span


@dataclass
class EngineStats:
    """Cumulative serving counters (read with ``engine.stats``).

    ``total_batch_time_s`` includes the first dispatch's kernel builds;
    call ``engine.reset_stats()`` after a warm-up batch when measuring
    steady-state throughput.  ``assemble_time_s`` is batch assembly (the
    queue drain and the row copies into the ping-pong buffer, from the
    first request's arrival, and the wrap-padding); ``fetch_time_s`` is
    the wait for the device result plus the host copy of the rows out of
    the pinned buffer, split as ``sync_wait_s + copy_out_s``.

    The dispatcher's other phases, in seconds summed over batches:
    ``wait_first_s`` blocked on a batch's first request (the queue was
    empty); ``dispatch_s`` the call that enqueues the upload, the forward
    and the copy back (on the CPU, the whole forward); ``resolve_s``
    setting the futures, which runs the clients' callbacks.
    ``queue_wait_s``: summed over requests, from ``submit`` to the close
    of the batch that takes the request."""

    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    total_batch_time_s: float = 0.0
    assemble_time_s: float = 0.0
    fetch_time_s: float = 0.0
    queue_wait_s: float = 0.0
    wait_first_s: float = 0.0
    dispatch_s: float = 0.0
    sync_wait_s: float = 0.0
    copy_out_s: float = 0.0
    resolve_s: float = 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of real (non-padding) slots per dispatched batch."""
        total = self.requests + self.padded_slots
        return self.requests / total if total else 0.0

    @property
    def slices_per_sec(self) -> float:
        if self.total_batch_time_s == 0:
            return 0.0
        return self.requests / self.total_batch_time_s


@dataclass
class _Pending:
    x: np.ndarray
    future: Future
    t_submit: float  # time.perf_counter() at submit


class InferenceEngine:
    """Threaded micro-batching wrapper around one forward.

    Parameters
    ----------
    apply_fn : ``(B, H, W, C_in)`` float32 tensor on ``device`` ->
        ``(B, H, W, C_out)`` tensor on ``device``.
    batch_size : static micro-batch size.
    input_shape : per-request ``(H, W, C_in)``.
    max_delay_ms : max time to hold an open batch waiting for more requests
        once it has at least one.  0 dispatches immediately.
    device : where ``apply_fn`` runs; ``None`` means the card (raises
        without one).
    """

    def __init__(
        self,
        apply_fn: Callable,
        batch_size: int = 128,
        input_shape: Tuple[int, int, int] = (256, 256, 2),
        max_delay_ms: float = 2.0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._apply = apply_fn
        self.batch_size = int(batch_size)
        self.input_shape = tuple(input_shape)
        self.max_delay_s = max_delay_ms / 1e3
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.stats = EngineStats()
        self._closed = False
        self._close_lock = threading.Lock()
        self._busy_until = 0.0  # end of the last accounted busy interval
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        # ping-pong host batches, pinned on the card so the upload is a DMA
        # that overlaps the next assembly; rows are written through numpy
        # views as requests arrive
        self._inputs = [
            torch.empty((self.batch_size, *self.input_shape),
                        dtype=torch.float32, pin_memory=cuda)
            for _ in range(2)
        ]
        self._buffers = [t.numpy() for t in self._inputs]
        self._outputs: List[Optional[torch.Tensor]] = [None, None]
        self._buf_idx = 0
        self._batch_no = 0  # ordinal of the batch being collected
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def reset_stats(self) -> None:
        """Zero the counters (e.g. after a warm-up batch)."""
        self.stats = EngineStats()
        self._busy_until = 0.0

    # ------------------------------------------------------------ client
    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one ``(H, W, C_in)`` request; returns a Future of
        ``(H, W, C_out)``."""
        x = np.asarray(x, np.float32)
        if x.shape != self.input_shape:
            raise ValueError(
                f"request shape {x.shape} != engine input {self.input_shape}"
            )
        item = _Pending(x=x, future=Future(), t_submit=time.perf_counter())
        # lock against close(): a request enqueued between the closed-check
        # and put() could otherwise land after the sentinel and never resolve
        with self._close_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.put(item)
        return item.future

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Blocking single-request convenience."""
        return self.submit(x).result()

    def predict_many(self, xs: List[np.ndarray]) -> List[np.ndarray]:
        futures = [self.submit(x) for x in xs]
        return [f.result() for f in futures]

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- dispatcher
    def _collect(self, buf: np.ndarray) -> Optional[List[_Pending]]:
        """Block for the first request, then drain up to batch_size within
        max_delay, copying each row straight into ``buf``."""
        k = self._batch_no
        t_wait = time.perf_counter()
        with span("engine.wait_first", batch=k):
            first = self._queue.get()
        if first is None:
            return None
        t_asm = time.perf_counter()  # the blocking wait above is idle time
        self.stats.wait_first_s += t_asm - t_wait
        with span("engine.collect", batch=k):
            buf[0] = first.x
            batch = [first]
            submitted = first.t_submit
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                try:
                    nxt = (
                        self._queue.get_nowait()
                        if remaining <= 0
                        else self._queue.get(timeout=remaining)
                    )
                except queue.Empty:
                    break
                if nxt is None:  # close sentinel: put it back for the loop
                    self._queue.put(None)
                    break
                buf[len(batch)] = nxt.x
                batch.append(nxt)
                submitted += nxt.t_submit
        t_end = time.perf_counter()
        self.stats.assemble_time_s += t_end - t_asm
        self.stats.queue_wait_s += len(batch) * t_end - submitted
        return batch

    @staticmethod
    def _set(future: Future, *, result=None, exception=None) -> None:
        """Resolve a future, tolerating client-side cancellation: a raised
        InvalidStateError here would kill the dispatcher thread."""
        try:
            if exception is not None:
                future.set_exception(exception)
            else:
                future.set_result(result)
        except Exception:
            pass  # cancelled by the client; nothing to deliver

    def _dispatch(self, i: int):
        """Launch the forward on input buffer ``i``; returns the host
        result tensor and the event that marks it complete (None on CPU)."""
        if self._stream is None:
            return self._apply(self._inputs[i]), None
        with torch.cuda.stream(self._stream):
            y = self._apply(self._inputs[i].to(self.device, non_blocking=True))
            out = self._outputs[i]
            if out is None or out.shape != y.shape or out.dtype != y.dtype:
                out = self._outputs[i] = torch.empty(
                    y.shape, dtype=y.dtype, pin_memory=True)
            out.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _resolve(self, pending) -> None:
        """Wait for a dispatched batch's result and resolve its futures."""
        host_out, done, batch, t0, k = pending
        n = len(batch)
        t_fetch = time.perf_counter()
        try:
            if done is not None:
                with span("engine.sync", batch=k):
                    done.synchronize()
            t_sync = time.perf_counter()
            # copied out: the pinned buffer is reused two batches later
            with span("engine.copy_out", batch=k):
                out = host_out[:n].numpy().copy()
        except Exception as e:
            for p in batch:
                self._set(p.future, exception=e)
            return
        now = time.perf_counter()
        sync_wait, copy_out = t_sync - t_fetch, now - t_sync
        self.stats.sync_wait_s += sync_wait
        self.stats.copy_out_s += copy_out
        self.stats.fetch_time_s += sync_wait + copy_out
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.padded_slots += self.batch_size - n
        # with one batch in flight, [t0, now] intervals overlap; count only
        # the non-overlapping part so slices_per_sec reflects wall-clock
        self.stats.total_batch_time_s += now - max(t0, self._busy_until)
        self._busy_until = now
        with span("engine.resolve", batch=k):
            for j, p in enumerate(batch):
                self._set(p.future, result=out[j])
        self.stats.resolve_s += time.perf_counter() - now

    def _loop(self):
        pending = None
        while True:
            if pending is not None and self._queue.empty():
                # a lone request resolves now, not when the next one comes
                self._resolve(pending)
                pending = None
                continue
            i = self._buf_idx
            xs = self._buffers[i]
            batch = self._collect(xs)
            if batch is None:
                if pending is not None:
                    self._resolve(pending)
                return
            k = self._batch_no
            self._batch_no += 1
            n = len(batch)
            if n < self.batch_size:
                # wrap-pad to the static batch (results are discarded)
                t_pad = time.perf_counter()
                with span("engine.pad", batch=k):
                    for j in range(n, self.batch_size):
                        xs[j] = xs[j % n]
                self.stats.assemble_time_s += time.perf_counter() - t_pad
            t0 = time.perf_counter()
            try:
                with span("engine.dispatch", batch=k):
                    host_out, done = self._dispatch(i)
            except Exception as e:  # resolve, don't kill the dispatcher
                for p in batch:
                    self._set(p.future, exception=e)
                continue  # buffer not in flight: reuse it
            self.stats.dispatch_s += time.perf_counter() - t0
            # flip only after a successful dispatch: the other buffer's batch
            # (pending) resolves before that buffer is written again
            self._buf_idx ^= 1
            if pending is not None:
                self._resolve(pending)
            pending = (host_out, done, batch, t0, k)


def _bn_over_bf16(bn: torch.nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax's eval-mode BatchNorm of a float32 module over bf16 variables:
    dtype promotion leaves ``rsqrt(var + eps) * scale`` a bf16 computation
    (each op rounded; eps rounded to bf16 first), and the rest float32."""
    bf16, shape = torch.bfloat16, (1, -1, 1, 1)
    rstd = torch.rsqrt((bn.running_var.to(bf16) + torch.tensor(
        bn.eps, dtype=bf16)).float()).to(bf16)
    mul = (rstd * bn.weight.to(bf16)).float()
    return ((x - bn.running_mean.view(shape)) * mul.view(shape)
            + bn.bias.view(shape))


def bf16_rounded_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` in eval mode with every float32 parameter and
    buffer rounded to bf16 (and kept float32)."""
    module = copy.deepcopy(module).eval()
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            if t.dtype == torch.float32:
                t.copy_(t.bfloat16().float())
    return module


def _bf16_weights_apply(module: torch.nn.Module) -> Callable:
    """The reference's ``quant='none'`` engine forward: every float32
    parameter and buffer rounded to bf16, the module itself still float32,
    so the forward is float32 arithmetic over bf16-rounded weights (but a
    BatchNorm's scale factor, which :func:`_bn_over_bf16` computes in bf16
    as flax does).  It runs with TF32 off (``fp32_reference``), the float32
    the reference computes on the CPU."""
    module = bf16_rounded_copy(module)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.forward = functools.partial(_bn_over_bf16, m)

    @torch.no_grad()
    def apply(x: torch.Tensor) -> torch.Tensor:
        with fp32_reference():
            return module(x.float())

    return apply


def engine_from_model(
    model_name: str = "unet",
    models_dir: str = "models",
    quant: str = "none",
    batch_size: int = 128,
    image_size: Tuple[int, int] = (256, 256),
    calibration_batches: Optional[List] = None,
    cfg=None,
    data_parallel: bool = False,
    require_checkpoint: bool = True,
    device: DeviceLike = None,
    devices: Optional[List] = None,
    **engine_kwargs,
) -> InferenceEngine:
    """A serving engine on ``device`` (``None``: the card) from a
    checkpoint (counterpart: ``mrisr_tpu/serve/engine.py:
    engine_from_model``).

    quant='none': the BN-folded float32 forward over bf16-rounded weights.
    quant='int8': ``unet_int8_apply`` (kernel A's float epilogue at every
    3x3 conv); 'int8_fused': the int8-resident forward (kernels A and B).
    Both need ``calibration_batches`` (a few ``(B, H, W, 2)`` arrays).
    ``require_checkpoint`` (default True): a missing checkpoint raises
    instead of serving fresh weights.  ``data_parallel=True`` splits each
    micro-batch over ``devices`` (``None``: every visible card), one
    replica of the forward and its int8 tables a device
    (:func:`data_parallel_apply`)."""
    from mrisr_tpu_torch.api import load_model

    device = resolve_device(device)
    # a serving engine quietly built on random weights (a typo'd
    # models_dir) would serve garbage with no error
    loaded = load_model(model_name, models_dir=models_dir, cfg=cfg,
                        fold_bn=True, device=device,
                        checkpoint="required" if require_checkpoint else None)
    if loaded.kind != "pair":
        raise ValueError("the serving engine batches 2-in/1-out pair models; "
                         f"{model_name!r} is kind={loaded.kind!r}")
    if quant in ("int8", "int8_fused"):
        from mrisr_tpu_torch.serve.quant import (
            Int8FusedUNet,
            Int8UNet,
            calibrate_unet,
            quantize_unet,
        )

        if not hasattr(loaded.module, "enc1"):
            # quantize_unet walks the UNet block names
            raise ValueError(
                "int8 serving covers the UNet-family topology; "
                f"{model_name!r} has no enc1 block: serve it with "
                "quant='none'")
        if not calibration_batches:
            raise ValueError("int8 serving requires calibration_batches")
        qparams = quantize_unet(loaded.module, calibrate_unet(
            loaded.module, calibration_batches))
        cls = Int8FusedUNet if quant == "int8_fused" else Int8UNet

        def make(d):
            return cls(qparams, device=d)
    else:
        def make(d):
            return _bf16_weights_apply(copy.deepcopy(loaded.module).to(d))
    apply_fn = (data_parallel_apply(make, batch_size, devices, device)
                if data_parallel else make(device))
    return InferenceEngine(apply_fn, batch_size=batch_size,
                           input_shape=(image_size[0], image_size[1], 2),
                           device=device, **engine_kwargs)


def _dp_devices(devices, device: torch.device) -> List[torch.device]:
    """``devices`` as torch devices; ``None``: every visible card when the
    engine runs on one, else the engine's own device (the CPU is one)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _rows_to(tree, rows: slice, device: torch.device):
    """``rows`` of every tensor in a nest of tuples and lists, on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree[rows].to(device)
    return type(tree)(_rows_to(t, rows, device) for t in tree)


def data_parallel_apply(make_apply: Callable, batch_size: int,
                        devices: Optional[List] = None,
                        device: DeviceLike = None) -> Callable:
    """A ``(B, H, W, C) -> (B, H, W, C')`` forward run data parallel
    (counterpart: ``mrisr_tpu/serve/engine.py:data_parallel_apply``).

    JAX replicates one jitted forward over a mesh of the local devices;
    here ``make_apply(device)`` builds one replica a device of
    ``devices`` (``None``: every visible card; see :func:`_dp_devices`),
    each with its own copy of the weights and int8 tables.  Each
    micro-batch (on ``device``, the engine's) is split into equal
    contiguous row blocks, block i runs on replica i, and the results are
    gathered back in order.  A replica with ``draw_noise`` (a diffusion
    bundle's sampler) gets its rows of the global batch's draws, made once
    on the first replica: the answers do not depend on the split.
    ``batch_size`` must divide by the device count."""
    devices = _dp_devices(devices, resolve_device(device))
    n = len(devices)
    if batch_size % n:
        raise ValueError(
            f"batch_size {batch_size} must divide over {n} devices")
    replicas = [make_apply(d) for d in devices]
    draw = getattr(replicas[0], "draw_noise", None)

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows must divide over {n} "
                             "devices")
        per = b // n
        noise = None if draw is None else draw(b, x.shape[1], x.shape[2])
        outs = []
        for i, (d, fwd) in enumerate(zip(devices, replicas)):
            rows = slice(i * per, (i + 1) * per)
            xi = x[rows].to(d)
            outs.append(fwd(xi) if noise is None
                        else fwd(xi, noise=_rows_to(noise, rows, d)))
        return torch.cat([o.to(x.device) for o in outs])

    return wrapped
