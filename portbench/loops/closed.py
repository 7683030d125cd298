"""Closed loop: ``clients`` threads each keep ``outstanding`` requests in
flight and send the next as soon as one resolves, so the engine's queue
never empties.  Requests are pairs drawn uniformly from the pool.

End-to-end: ``served_slices_per_s``, the requests of the batches that
completed in the window over its length, its edges at batch completions
(:func:`portbench.core.batch_edges`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict

import numpy as np

from portbench.core import batch_edges
from portbench.loops import LoopOut, Marks

RESULT_TIMEOUT_S = 60.0
DRAWS = 1 << 18  # a client's draws, reused in turn past that many


def run(engine, pool: np.ndarray, traffic: Dict[str, Any], seed: int,
        seconds: float, window, sample_size: int, rows=None) -> LoopOut:
    """``window(t0, t1)`` blocks the main thread until ``t1`` (and may
    profile inside).  ``rows``: a dict the engine's batch order fills
    (``id(future) -> row``), when the answer depends on the row."""
    clients = int(traffic["clients"])
    outstanding = int(traffic["outstanding"])
    n_vol, n_pair = pool.shape[:2]
    marks = Marks(engine)
    stop = threading.Event()
    out = LoopOut()
    lock = threading.Lock()
    per_client = -(-sample_size // clients)

    def client(k: int) -> None:
        # the draws in bulk, so that the client's share of the host (and
        # of the interpreter's lock) stays small
        rng = np.random.default_rng([seed % 2 ** 63, k])
        picks = rng.integers(n_vol * n_pair, size=DRAWS)
        keeps = rng.random(DRAWS)
        pending = collections.deque()
        kept, seen, attempted, failed = [], 0, 0, 0

        def send():
            v, p = divmod(int(picks[attempted % DRAWS]), n_pair)
            fut = engine.submit(pool[v, p])
            fut.add_done_callback(marks.record)
            pending.append((v, p, fut))

        for _ in range(outstanding):
            send()
            attempted += 1
        while pending:
            v, p, fut = pending.popleft()
            try:
                y = fut.result(timeout=RESULT_TIMEOUT_S)
            except Exception:  # an error or no answer: counted, not raised
                failed += 1
                continue
            row = rows.pop(id(fut), None) if rows is not None else None
            # reservoir sampling: each answer kept with equal chance
            if len(kept) < per_client:
                kept.append((v, p, y.copy(), row))
            else:
                j = int(keeps[seen % DRAWS] * (seen + 1))
                if j < per_client:
                    kept[j] = (v, p, y.copy(), row)
            seen += 1
            if not stop.is_set():
                send()
                attempted += 1
        with lock:
            out.samples.extend(kept)
            out.attempted += attempted
            out.failed += failed

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    time.sleep(float(traffic.get("settle_s", 1.0)))
    t0 = time.perf_counter()
    t1 = t0 + seconds
    window(t0, t1)
    stop.set()
    for t in threads:
        t.join(RESULT_TIMEOUT_S + 30.0)
        if t.is_alive():
            raise RuntimeError("a client did not drain within its timeout")
    out.window = (t0, t1)
    out.marks = marks.items
    start, end, n = batch_edges(marks.items, t0, t1)
    out.rate = n / (end - start)
    out.metrics["served_slices_per_s"] = (out.rate, "slices/s")
    out.lines.append(f"closed loop: {clients} clients x {outstanding}; "
                     f"{n} slices in {end - start:.4f} s between batch "
                     f"completions")
    return out

