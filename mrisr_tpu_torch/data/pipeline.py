"""Store -> card feeding pipeline (counterpart: ``mrisr_tpu/data/pipeline.py``).

- Per-slice z-score + resize happen ONCE per volume, when the bank is built
  (the reference recomputed every triplet of a volume per ``__getitem__``,
  reference ``src/ModelDataGenerator.py:179-208``).
- A split's normalized slices live flat in a :class:`SliceBank`: host RAM
  (numpy), or a tensor on the card whose gathers run there.
- A batch is an integer gather plus one host-to-device copy, yielded as a
  contiguous float32 NHWC tensor ``(B, H, W, C)`` on the loader's device,
  with C = [pre, post, target] (triplets) or the 5-slice window.  A host
  bank's batch goes through pinned memory with a non-blocking copy.
- Train batches get paired augmentation on the loader's device, batch by
  batch (``ops/augment.py``), and :class:`PrefetchIterator` builds them on a
  background thread ahead of the consumer.

The loaders mirror ``build_dataloader`` / ``build_progressive_dataloader``
(reference ``src/ModelDataGenerator.py:217-284``,
``src/ModelDataGenerator_ProgressiveUNet.py:218-279``): the same
patient-level split, shuffle on train, distance filtering and drop_last.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mrisr_tpu_torch.config import DataConfig
from mrisr_tpu_torch.data.split import split_for
from mrisr_tpu_torch.data.triplets import TripletIndex, WindowIndex
from mrisr_tpu_torch.data.volumes import VolumeStore
from mrisr_tpu_torch.device import DeviceLike, resolve_device
from mrisr_tpu_torch.ops.augment import paired_augment
from mrisr_tpu_torch.ops.resize import resize_bilinear
from mrisr_tpu_torch.ops.stats import minmax_normalize, zscore_slices


def preprocess_volume(
    vol: np.ndarray,
    image_size: Tuple[int, int],
    value_range: str = "zscore",
) -> np.ndarray:
    """Z-score each slice at native resolution, then bilinear-resize (the
    reference's order: normalize first, ``:73-75``, resize second,
    ``:204-208``).  ``value_range='zscore_minmax11'`` additionally min-max
    maps each slice to [-1, 1] after the resize (the M10 lineage's working
    range).  Runs on the host; returns float32 numpy ``(Z, H', W')``."""
    if value_range not in ("zscore", "zscore_minmax11"):
        raise ValueError(
            f"value_range must be 'zscore' or 'zscore_minmax11', "
            f"got {value_range!r}"
        )
    x = torch.from_numpy(np.array(vol, np.float32))  # a writable copy
    x = resize_bilinear(zscore_slices(x), image_size)
    if value_range == "zscore_minmax11":
        x = minmax_normalize(x) * 2.0 - 1.0
    return x.numpy()


class SliceBank:
    """All normalized slices of a set of series, flat ``(S, H, W)``.

    backend='host'   -- float32 numpy array in RAM.
    backend='device' -- a tensor on ``device`` (bf16 by default, half the
                        memory); gathers run there.
    """

    def __init__(
        self,
        store: VolumeStore,
        series_idx: Sequence[int],
        image_size: Tuple[int, int] = (256, 256),
        backend: str = "host",
        device: DeviceLike = None,
        device_dtype: torch.dtype = torch.bfloat16,
        value_range: str = "zscore",
    ):
        if backend not in ("host", "device"):
            raise ValueError(f"backend must be 'host' or 'device', got "
                             f"{backend!r}")
        self.series_idx = list(series_idx)
        self.image_size = tuple(image_size)
        self.backend = backend
        self.value_range = value_range
        self.counts = store.slice_counts(self.series_idx)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.counts)]).astype(np.int64)
        h, w = self.image_size
        flat = np.empty((int(self.offsets[-1]), h, w), dtype=np.float32)
        for j, sidx in enumerate(self.series_idx):
            vol = store.load_series(sidx, mmap=True)
            flat[self.offsets[j]:self.offsets[j + 1]] = preprocess_volume(
                np.asarray(vol), self.image_size, value_range=value_range)
        if backend == "device":
            self.flat = torch.from_numpy(flat).to(
                resolve_device(device), device_dtype)
        else:
            self.flat = flat

    @property
    def num_slices(self) -> int:
        return int(self.offsets[-1])

    def flat_ids(self, series_local: np.ndarray,
                 slice_ids: np.ndarray) -> np.ndarray:
        """series-local index (position within this bank) + slice -> flat id."""
        return self.offsets[series_local] + slice_ids

    def gather(self, flat_ids: np.ndarray):
        """``(K, H, W)`` stack of normalized slices: numpy for the host
        bank, a tensor on the bank's device for the device bank."""
        if self.backend == "device":
            idx = torch.from_numpy(np.asarray(flat_ids, np.int64))
            return self.flat.index_select(0, idx.to(self.flat.device))
        return self.flat[flat_ids]


@dataclass
class _AugmentSpec:
    enabled: bool = False
    hflip: bool = True
    vflip: bool = True
    rot90: bool = False
    rotate_degrees: float = 0.0

    @classmethod
    def from_config(cls, cfg: DataConfig, train: bool = True
                    ) -> "_AugmentSpec":
        """The spec of ``cfg``: on when ``cfg.augment`` and ``train``."""
        return cls(enabled=cfg.augment and train, hflip=cfg.hflip,
                   vflip=cfg.vflip, rot90=cfg.rot90,
                   rotate_degrees=cfg.rotate_degrees)

    def apply(self, batch: torch.Tensor, generator: torch.Generator,
              rows: Optional[slice] = None,
              global_batch: Optional[int] = None) -> torch.Tensor:
        """``batch`` augmented with draws from ``generator``, or as it is
        when the spec is disabled; ``rows`` of ``global_batch``: the
        global batch's draws, this shard's rows of them."""
        if not self.enabled:
            return batch
        return paired_augment(batch, generator, hflip=self.hflip,
                              vflip=self.vflip, rot90=self.rot90,
                              rotate_degrees=self.rotate_degrees, rows=rows,
                              global_batch=global_batch)


class _BaseLoader:
    """Shared epoch iteration: shuffle, batch, pad or drop the tail, put on
    the device, augment.

    ``sharding`` (``parallel/mesh.py:batch_sharding``): every rank builds
    the same loader (same seed, same order) and yields only its rows of
    each global batch, gathered alone; the augmentation draws are the
    global batch's.  ``batch_size`` stays the global one."""

    def __init__(
        self,
        bank: SliceBank,
        plan_flat: np.ndarray,  # (N, C) flat slice ids per sample
        batch_size: int,
        shuffle: bool,
        seed: int,
        drop_last: bool,
        pad_final: str,
        device: DeviceLike,
        augment: Optional[_AugmentSpec] = None,
        sharding=None,
    ):
        if pad_final not in ("wrap", "partial"):
            raise ValueError(f"pad_final must be 'wrap' or 'partial', got "
                             f"{pad_final!r}")
        self.bank = bank
        self.plan_flat = plan_flat
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.device = resolve_device(device)
        self.augment = augment or _AugmentSpec()
        self.sharding = sharding
        if sharding is not None:
            sharding.rows(batch_size)  # raises unless it divides
        self._np_rng = np.random.default_rng(seed)
        # the augmentation draws: one stream on the loader's device
        self._aug_gen = torch.Generator(self.device).manual_seed(seed)

    def __len__(self) -> int:
        n = self.plan_flat.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return int(self.plan_flat.shape[0])

    def __iter__(self) -> Iterator[torch.Tensor]:
        n, c = self.plan_flat.shape
        order = np.arange(n)
        if self.shuffle:
            self._np_rng.shuffle(order)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            if idx.shape[0] < bs and self.pad_final == "wrap":
                # wrap-pad (tiling if the dataset is smaller than one batch)
                # keeps every batch one shape; exact-sample consumers trim
                # the tail with num_samples.  'partial' yields the true
                # final batch, so batch means average as the reference's
                # DataLoader loops did.
                idx = np.concatenate([idx, np.resize(order, bs - idx.shape[0])])
            n_global, rows = idx.shape[0], None
            if self.sharding is not None:
                rows = self.sharding.rows(n_global)
                idx = idx[rows]
            stack = self.bank.gather(self.plan_flat[idx].reshape(-1))
            if isinstance(stack, np.ndarray):
                stack = torch.from_numpy(stack)
                if self.device.type == "cuda":
                    stack = stack.pin_memory()
            stack = stack.to(self.device, torch.float32,
                             non_blocking=True).reshape(
                idx.shape[0], c, *self.bank.image_size)
            batch = stack.permute(0, 2, 3, 1).contiguous()  # NHWC
            yield self.augment.apply(batch, self._aug_gen, rows, n_global)


class TripletLoader(_BaseLoader):
    """Yields ``(B, H, W, 3)`` batches with channels [pre, post, target],
    with the d2/d4 offset rule and ``distance_filter`` in {None, 2, 4}
    (``TripletSliceDataset`` + ``build_dataloader``, reference
    ``src/ModelDataGenerator.py:118-284``).  ``distances`` holds each
    sample's 2 (3 mm) or 4 (6 mm)."""

    def __init__(
        self,
        bank: SliceBank,
        distance_filter: Optional[int],
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        drop_last: bool = False,
        pad_final: str = "wrap",
        device: DeviceLike = None,
        augment: Optional[_AugmentSpec] = None,
        sharding=None,
    ):
        plan = TripletIndex(bank.counts, distance_filter).slice_plan()
        # [series_local, pre, mid, post, dist] -> flat [pre, post, mid]: the
        # reference's ((pre, post), target) item order
        flat = np.stack([bank.flat_ids(plan[:, 0], plan[:, j])
                         for j in (1, 3, 2)], axis=1)
        self.distances = plan[:, 4].copy()
        super().__init__(bank, flat, batch_size, shuffle, seed, drop_last,
                         pad_final, device, augment, sharding)


class WindowLoader(_BaseLoader):
    """Yields ``(B, H, W, 5)`` windows [i..i+4] for the Progressive UNet
    (``ProgressiveUNetDataset``, reference
    ``src/ModelDataGenerator_ProgressiveUNet.py:99-215``)."""

    def __init__(
        self,
        bank: SliceBank,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        drop_last: bool = False,
        pad_final: str = "wrap",
        device: DeviceLike = None,
        augment: Optional[_AugmentSpec] = None,
        sharding=None,
    ):
        plan = WindowIndex(bank.counts).slice_plan()  # [series_local, i..i+4]
        flat = np.stack([bank.flat_ids(plan[:, 0], plan[:, 1 + j])
                         for j in range(5)], axis=1)
        super().__init__(bank, flat, batch_size, shuffle, seed, drop_last,
                         pad_final, device, augment, sharding)


class PrefetchIterator:
    """Builds up to ``depth`` batches ahead of the consumer on a background
    thread (gather, host-to-device copy and augmentation launches): the
    role DataLoader workers played in the reference, without processes.

    Every batch the loader yields reaches the consumer, the tail included:
    the end marker goes through the same bounded put as the batches.  A
    consumer that stops early (``break``) sets the stop flag, and the
    worker then gives up its pending put.  An exception in the worker is
    raised on the consumer's side."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = max(depth, 1)

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        # a transparent proxy for the loader's attributes (bank, plan_flat)
        return getattr(self.loader, name)

    @property
    def num_samples(self) -> int:
        return self.loader.num_samples

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            # bounded and stop-aware: blocks while the queue is full, so no
            # batch is evicted; gives up only once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # re-raised on the consumer's side
                error.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
            t.join()
            if error:
                raise error[0]
        finally:
            # also reached when the consumer closes the generator early
            stop.set()
            t.join(timeout=5)


def host_shard_patients(patients, process_index: Optional[int] = None,
                        process_count: Optional[int] = None):
    """Round-robin patient shard for multi-process data parallelism: each
    process reads only its own patients.  Rank and world size default to
    ``torch.distributed``'s when it is initialized, else one process."""
    if process_count is None or process_index is None:
        dist = torch.distributed
        initialized = dist.is_available() and dist.is_initialized()
        if process_count is None:
            process_count = dist.get_world_size() if initialized else 1
        if process_index is None:
            process_index = dist.get_rank() if initialized else 0
    if process_count <= 1:
        return list(patients)
    return [p for i, p in enumerate(patients)
            if i % process_count == process_index]


def build_loader(
    store: VolumeStore,
    split: str,
    cfg: DataConfig,
    kind: str = "triplet",
    backend: str = "host",
    device: DeviceLike = None,
    seed: int = 0,
    bank: Optional[SliceBank] = None,
    shard_by_host: bool = False,
    sharding=None,
):
    """The ``build_dataloader`` analog: split -> bank -> loader, batches on
    ``device`` (``None``: the card).  The train split is shuffled (numpy's
    ``default_rng(seed)``), augmented when ``cfg.augment``, and wrapped in a
    :class:`PrefetchIterator` when ``cfg.prefetch``.

    ``bank``: reuse a SliceBank already built for the same split (the bank
    does not depend on ``distance_filter``, so the per-spacing eval builds
    it once).  ``shard_by_host``: this process reads only its round-robin
    share of the split's patients (:func:`host_shard_patients`; under a
    ``sharding``, the share of its data coordinate).
    ``sharding`` (``parallel/mesh.py:batch_sharding``): yield this rank's
    rows of each global batch.  With ``shard_by_host`` too, each rank
    takes its rows of a batch of its own patients, as the JAX loader's
    ``device_put`` of each host's batch onto the global sharding does."""
    if kind not in ("triplet", "window"):
        raise ValueError(f"unknown loader kind: {kind}")
    if bank is None:
        patients = split_for(store.patient_ids, split, cfg.test_val_fraction,
                             cfg.test_within_fraction, cfg.split_seed)
        if shard_by_host:
            # under a mesh the ranks of one data coordinate take the same
            # rows, so the shards go by data coordinate
            patients = host_shard_patients(
                patients, *((sharding.rank, sharding.size)
                            if sharding is not None else (None, None)))
        bank = SliceBank(store, store.series_for_patients(patients),
                         cfg.image_size, backend=backend, device=device,
                         value_range=cfg.value_range)
    train = split == "train"
    aug = _AugmentSpec.from_config(cfg, train)
    # train keeps one batch shape (wrap-pad); eval splits yield the true
    # partial final batch
    pad_final = "wrap" if train else "partial"
    if kind == "triplet":
        loader = TripletLoader(bank, cfg.distance_filter, cfg.batch_size,
                               shuffle=train, seed=seed, pad_final=pad_final,
                               device=device, augment=aug, sharding=sharding)
    else:
        loader = WindowLoader(bank, cfg.batch_size, shuffle=train, seed=seed,
                              drop_last=train, pad_final=pad_final,
                              device=device, augment=aug, sharding=sharding)
    if cfg.prefetch and train:
        return PrefetchIterator(loader, depth=cfg.prefetch)
    return loader
