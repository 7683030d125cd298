"""Find the volume rate a served configuration sustains: one engine, rising
offered rates of the open loop, one short window each.

    python3 portbench/sweep_volumes.py --workload unet_m2.serve_volumes \
        --seed 5 --seconds 6 --rates 60 100 140 180 220

For each rate it prints the completed volume rate, the backlog (requests
submitted and not yet resolved) at the middle and at the end of the
window, and the volume latency's p50 and p95.  The knee is the highest
rate whose backlog does not grow over the window; the cell offers a fixed
share of it (``traffic/<mix>.json``'s ``volumes_per_s``).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def backlog(out, n_pair: int, due, at: float) -> int:
    """Requests submitted by time ``at`` and not resolved by then."""
    t0 = out.window[0]
    sent = n_pair * int(sum(1 for d in due if t0 + d <= at))
    return sent - sum(1 for t, _ in out.marks if t <= at)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import core
    from portbench.loops import open as open_loop
    from portbench.reference.phantom import pair_pool

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = core.with_deferred(core.benchmark())
    spec = core.cell(bench, args.workload)
    cfg = core.data_file("configs", spec["config"])
    traffic = core.data_file("traffic", spec["traffic"])
    fam = core.module("families", cfg["family"])
    pool = pair_pool(args.seed, int(traffic["pool_volumes"]),
                     int(cfg["volume"]["slices"]), int(cfg["image_size"]),
                     int(traffic.get("pair_gap", 2)))
    w = fam.weights(cfg, args.seed, device)
    n_pair = pool.shape[1]
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        engine = fam.build(cfg, w, core.calibration(cfg, pool, args.seed),
                           workdir, device, traffic["engine"])
        try:
            flat = pool.reshape(-1, *pool.shape[2:])
            engine.predict_many([flat[i % len(flat)] for i in
                                 range(2 * int(traffic["engine"]
                                               ["batch_size"]))])
            for rate in args.rates:
                tr = dict(traffic, volumes_per_s=rate)
                out = open_loop.run(
                    engine, pool, tr, args.seed, args.seconds,
                    lambda t0, t1: time.sleep(max(0.0, t1 -
                                                  time.perf_counter())),
                    0)
                due, _ = open_loop.schedule(args.seed, rate, args.seconds,
                                            pool.shape[0])
                t0, t1 = out.window
                lat = out.latency_ms
                done = sum(1 for t, _ in out.marks if t <= t1) / n_pair
                print(json.dumps({
                    "offered_volumes_per_s": rate,
                    "completed_volumes_per_s": done / (t1 - t0),
                    "backlog_mid": backlog(out, n_pair, due, (t0 + t1) / 2),
                    "backlog_end": backlog(out, n_pair, due, t1),
                    "p50_ms": core.percentile(lat, 50),
                    "p95_ms": core.percentile(lat, 95),
                    "late_p95_ms": core.percentile(out.lateness_ms, 95),
                    "failed": out.failed}), flush=True)
        finally:
            engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
