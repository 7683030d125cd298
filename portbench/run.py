"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload unet_m2.serve_saturate --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, the port
(``mrisr_tpu_torch``) and ``portbench/``.  It builds the served program
from seeded weights and inputs, warms it up, offers the cell's traffic
for ``--seconds``, holds a sample of the answers to the plain reference,
and prints one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from the benchmark's spans, the engine's counters and ``torch.profiler``.
The numbers compared close standard error and the line (``check``).

Exits 2 without a card (or fewer than the cell asks for), 3 when JAX or
the JAX package was loaded, 1 on any other failure; then it prints no
result.  Kernel and compiler caches stay under ``build/`` in the
checkout; bundles and checkpoints go to a temporary directory under
``TMPDIR``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import core
    from portbench.cell import run_cell

    bench = core.benchmark()
    spec = core.cell(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(spec["chips"])):
        print(f"portbench: {args.workload} needs {spec['chips']} CUDA "
              "card(s); none usable here", file=sys.stderr)
        return 2
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    loaded = core.forbidden_loaded()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(core.result_line(res["correct"], res["attempted"], res["failed"],
                           res["metrics"], res["device"], res["checks"],
                           res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
