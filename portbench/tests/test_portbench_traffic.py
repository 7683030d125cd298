"""The traffic generators are seeded and reproducible, and the open loop's
schedule follows its rate."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from portbench.loops import closed, open as open_loop


class FakeEngine:
    """Resolves each request at once with its input's first channel, in
    batches of ``batch`` (the ordinal in ``stats.batches``)."""

    class Stats:
        batches = 0

    def __init__(self, batch=4):
        self.batch, self.stats, self.sent = batch, self.Stats(), []
        self.lock = threading.Lock()
        self.n = 0

    def submit(self, x):
        fut = Future()
        with self.lock:
            self.sent.append(float(x.ravel()[0]))
            if self.n % self.batch == 0:
                self.stats.batches += 1
            self.n += 1
        fut.set_result(x[..., :1])
        return fut


def pool(v=3, p=5, hw=4):
    return np.arange(v * p * hw * hw * 2, dtype=np.float32).reshape(
        v, p, hw, hw, 2)


def sleeper(t0, t1):
    time.sleep(max(0.0, t1 - time.perf_counter()))


def test_open_schedule_follows_its_rate_and_seed():
    due, vols = open_loop.schedule(2 ** 31 + 5, 150.0, 20.0, 8)
    assert len(due) == 3000 and len(vols) == 3000
    assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 20.0
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / 150.0, rel=0.05)
    # a Poisson process: the gaps' spread is their mean
    assert gaps.std() == pytest.approx(gaps.mean(), rel=0.1)
    assert set(vols.tolist()) == set(range(8))
    again = open_loop.schedule(2 ** 31 + 5, 150.0, 20.0, 8)
    assert np.array_equal(due, again[0]) and np.array_equal(vols, again[1])
    other = open_loop.schedule(7, 150.0, 20.0, 8)
    assert len(other[0]) == 3000 and not np.array_equal(due, other[0])


def test_open_loop_submits_each_volume_whole():
    eng = FakeEngine(batch=5)
    p = pool()
    out = open_loop.run(eng, p, {"volumes_per_s": 20}, 11, 0.5, sleeper, 6)
    assert out.attempted == 10 * 5 == len(eng.sent) and out.failed == 0
    assert out.metrics["volume_p95_ms"][0] >= 0
    assert len(out.samples) == 2 * 5  # whole volumes, enough for 6
    _, vols = open_loop.schedule(11, 20, 0.5, 3)
    firsts = [eng.sent[i] for i in range(0, 50, 5)]
    assert firsts == [float(p[v, 0].ravel()[0]) for v in vols]


def test_closed_loop_draws_repeat_with_the_seed():
    def draws(seed):
        eng = FakeEngine()
        out = closed.run(eng, pool(), {"clients": 1, "outstanding": 3,
                                       "settle_s": 0.0}, seed, 0.05,
                         sleeper, 4)
        assert out.failed == 0 and out.rate > 0 and len(out.samples) == 4
        return eng.sent[:50]

    assert draws(2 ** 32 + 1) == draws(2 ** 32 + 1)
    assert draws(2 ** 32 + 1) != draws(3)
