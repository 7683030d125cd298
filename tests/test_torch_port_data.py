"""Port data layer against mrisr_tpu's (CPU): the patient split without
scikit-learn, the store format both ways, and the loaders' batches."""

import dataclasses

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_train_test_split

from mrisr_tpu.config import DataConfig as JaxDataConfig
from mrisr_tpu.data.pipeline import build_loader as jax_build_loader
from mrisr_tpu.data.split import split_for as jax_split_for
from mrisr_tpu.data.synthetic import make_synthetic_store as jax_make_store
from mrisr_tpu.data.volumes import VolumeStore as JaxVolumeStore
from mrisr_tpu.ops.stats import slice_stats as jax_slice_stats
from mrisr_tpu.data import triplets as jax_triplets
from mrisr_tpu_torch.data import triplets as port_triplets
from mrisr_tpu_torch.config import DataConfig
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.split import split_for, train_test_split
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.data.volumes import VolumeStore
from mrisr_tpu_torch.ops.stats import slice_stats

torch.set_num_threads(2)

# 90, 170, 180: where floor((1 - 0.3) * n) would give another n_train
SPLIT_NS = [3, 4, 8, 10, 17, 90, 170, 180, 1151]


@pytest.mark.parametrize("n", SPLIT_NS)
def test_train_test_split_matches_sklearn(n):
    items = [f"Patient-{i:05d}" for i in range(n)]
    for frac in (0.3, 0.6):
        assert list(train_test_split(items, frac, 42)) == sk_train_test_split(
            items, test_size=frac, random_state=42), frac


@pytest.mark.parametrize("n", [n for n in SPLIT_NS if n >= 8])
def test_split_for_matches_jax(n):
    ids = [f"Patient-{i:05d}" for i in np.random.default_rng(n).permutation(n)]
    for split in ("train", "val", "test"):
        assert split_for(ids, split) == jax_split_for(ids, split), split


def test_split_refuses_an_empty_split():
    """Where scikit-learn refuses (3 patients leave 1 for val + test)."""
    ids = ["a", "b", "c"]
    with pytest.raises(ValueError):
        jax_split_for(ids, "test")
    with pytest.raises(ValueError, match="empty split"):
        split_for(ids, "test")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """8 patients x 10 slices at 48^2 (the loaders resize to 32^2)."""
    return make_synthetic_store(str(tmp_path_factory.mktemp("port_store")),
                                num_patients=8, slices_per_volume=10,
                                height=48, width=48)


def _same_store(a, b):
    assert a.patient_ids == b.patient_ids
    assert len(a) == len(b)
    for i in range(len(a)):
        assert a.entries[i].to_dict() == b.entries[i].to_dict()
        np.testing.assert_array_equal(a.load_series(i), b.load_series(i))


def test_port_store_opens_in_jax(store):
    _same_store(JaxVolumeStore.open(store.root), store)


def test_jax_store_opens_in_port(tmp_path, store):
    """Same phantoms bit for bit, packed by the JAX package, read here."""
    jax_store = jax_make_store(str(tmp_path / "jax"), num_patients=8,
                               slices_per_volume=10, height=48, width=48)
    _same_store(VolumeStore.open(jax_store.root), store)


def test_pack_rejects_non_volume(tmp_path):
    with pytest.raises(ValueError, match="expected"):
        VolumeStore.pack(str(tmp_path), [("p", "s", np.zeros((4, 4)))])


def _batches(loader):
    return [np.asarray(b, np.float32) for b in loader]


def assert_batch_close(got, want, bf16=False):
    """atol 1e-6 plus rtol 1e-6 (8 float32 ulps): z-scores reach about 8,
    where one ulp is 1e-6, and the frameworks sum a slice's mean and
    interpolate the resize in different orders (tests/test_resize.py holds
    the two resizes to 2e-5).  A bf16 bank rounds those float32 values, so
    a value on a rounding boundary may move by one bf16 ulp (2^-7
    relative at the bottom of a binade)."""
    np.testing.assert_allclose(got, want, atol=1e-6,
                               rtol=2.0 ** -7 if bf16 else 1e-6)


@pytest.mark.parametrize("value_range", ["zscore", "zscore_minmax11"])
@pytest.mark.parametrize("distance", [2, 4, None])
@pytest.mark.parametrize("split", ["test", "val"])
def test_triplet_loader_matches_jax(store, split, distance, value_range):
    kw = dict(batch_size=4, image_size=(32, 32), distance_filter=distance,
              value_range=value_range)
    jl = jax_build_loader(JaxVolumeStore.open(store.root), split,
                          JaxDataConfig(**kw))
    pl = build_loader(store, split, DataConfig(**kw), device="cpu")
    assert pl.num_samples == jl.num_samples
    np.testing.assert_array_equal(pl.distances, jl.distances)
    got, want = _batches(pl), _batches(jl)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[-1].shape[0] == (pl.num_samples - 1) % 4 + 1  # partial tail
    for g, w in zip(got, want):
        assert_batch_close(g, w)


def test_train_loader_order_and_wrap_pad_match_jax(store):
    kw = dict(batch_size=5, image_size=(32, 32), augment=False)
    jl = jax_build_loader(JaxVolumeStore.open(store.root), "train",
                          JaxDataConfig(prefetch=0, **kw), seed=3)
    pl = build_loader(store, "train", DataConfig(**kw), device="cpu", seed=3)
    for _ in range(2):  # two epochs: the shuffle stream continues
        got, want = _batches(pl), _batches(jl)
        assert all(g.shape[0] == 5 for g in got)
        for g, w in zip(got, want):
            assert_batch_close(g, w)


def test_device_bank_and_window_loader_match_jax(store):
    """The device bank (bf16) and the 5-slice windows, both on the CPU."""
    kw = dict(batch_size=3, image_size=(32, 32))
    jstore = JaxVolumeStore.open(store.root)
    jl = jax_build_loader(jstore, "test", JaxDataConfig(**kw),
                          backend="device")
    pl = build_loader(store, "test", DataConfig(**kw), backend="device",
                      device="cpu")
    assert pl.bank.flat.dtype == torch.bfloat16
    for g, w in zip(_batches(pl), _batches(jl)):
        assert_batch_close(g, w, bf16=True)
    jl = jax_build_loader(jstore, "val", JaxDataConfig(**kw), kind="window")
    pl = build_loader(store, "val", DataConfig(**kw), kind="window",
                      device="cpu")
    got, want = _batches(pl), _batches(jl)
    assert got[0].shape == (3, 32, 32, 5) and len(got) == len(want)
    for g, w in zip(got, want):
        assert_batch_close(g, w)


def test_bank_reuse_across_spacings(store):
    cfg = DataConfig(batch_size=4, image_size=(32, 32), distance_filter=2)
    l2 = build_loader(store, "test", cfg, device="cpu")
    l4 = build_loader(store, "test", dataclasses.replace(cfg,
                                                         distance_filter=4),
                      device="cpu", bank=l2.bank)
    assert l4.bank is l2.bank
    assert set(l2.distances) == {2} and set(l4.distances) == {4}


@pytest.mark.parametrize("n", [3, 5, 10, 60])
def test_index_math_and_stats_match_jax(n):
    """The copied index math (eval generators, d2/d4 plan) and slice_stats."""
    for name in ("eval_volume_triplets", "eval_hierarchical_pairs",
                 "eval_progressive_windows", "recursive_bisection_triplets"):
        np.testing.assert_array_equal(getattr(port_triplets, name)(n),
                                      getattr(jax_triplets, name)(n))
    counts = [n, n + 1, 2]
    for df in (None, 2, 4):
        np.testing.assert_array_equal(
            port_triplets.TripletIndex(counts, df).slice_plan(),
            jax_triplets.TripletIndex(counts, df).slice_plan())
    x = np.random.default_rng(n).random((2, n, 7)).astype(np.float32) * 50
    for got, want in zip(slice_stats(torch.from_numpy(x)),
                         jax_slice_stats(x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_train_augment_raises(store):
    """Train augmentation runs: each sample is a flip of the same sample
    unaugmented (same shuffle seed), the channels flipped together; rot90
    on non-square images raises."""
    kw = dict(batch_size=4, image_size=(32, 32))
    plain = _batches(build_loader(store, "train", DataConfig(**kw),
                                  device="cpu", seed=1))
    aug = _batches(build_loader(store, "train", DataConfig(augment=True, **kw),
                                device="cpu", seed=1))
    assert len(aug) == len(plain)
    seen = set()
    for a, p in zip(aug, plain):
        for i in range(p.shape[0]):
            variants = [p[i], np.flip(p[i], 1), np.flip(p[i], 0),
                        np.flip(p[i], (0, 1))]
            match = [j for j, v in enumerate(variants)
                     if np.array_equal(a[i], v)]
            assert match, "an augmented sample is no flip of its source"
            seen.add(match[0])
    assert len(seen) > 1
    loader = build_loader(store, "train", DataConfig(
        augment=True, rot90=True, image_size=(32, 48)), device="cpu")
    with pytest.raises(ValueError, match="square"):
        next(iter(loader))


def test_prefetch_delivers_every_batch_and_stops():
    """The bounded queue delivers the tail with a slow consumer, a consumer
    that breaks early stops the worker, and a loader error is re-raised."""
    import time

    from mrisr_tpu_torch.data.pipeline import PrefetchIterator

    class Source:
        def __init__(self, n, fail_at=None):
            self.n, self.fail_at, self.made = n, fail_at, 0

        def __len__(self):
            return self.n

        def __iter__(self):
            for i in range(self.n):
                if i == self.fail_at:
                    raise RuntimeError("loader failed")
                self.made += 1
                yield i

    src = Source(9)
    it = PrefetchIterator(src, depth=2)
    got = []
    for x in it:
        time.sleep(0.01)
        got.append(x)
    assert got == list(range(9)) and len(it) == 9 and it.n == 9
    src = Source(1000)
    for x in PrefetchIterator(src, depth=2):
        if x == 3:
            break
    time.sleep(0.3)
    assert src.made < 10
    with pytest.raises(RuntimeError, match="loader failed"):
        list(PrefetchIterator(Source(5, fail_at=3), depth=2))


def test_host_shard_patients():
    from mrisr_tpu_torch.data.pipeline import host_shard_patients

    pats = [f"p{i}" for i in range(7)]
    assert host_shard_patients(pats) == pats  # no process group: one shard
    shards = [host_shard_patients(pats, r, 3) for r in range(3)]
    assert shards[1] == ["p1", "p4"]
    assert sorted(sum(shards, [])) == sorted(pats)
