"""The readings a cell's limit is set from, in one process on the card.

    python3 portbench/control.py --workload unet_m2.serve_saturate \
        --seeds 101 102 103 --seconds 4 --bits 4

For each seed: the cell's whole set-up and a short window at its own
load, then the numbers compared for the program's answers (the lower
reading comes from these) and for the plain reference at ``bits`` (a
training cell: float8) in the program's place on the same requests or
batches (the control; the upper reading is the least of these).  With
``--fault`` a fault of ``faults.py`` is planted under the timed path and
the program's readings are the fault's.  Prints one line a seed, with
the harness's own decision (``core.passes`` against the cell's limit) on
the program's or the fault's answers and on the control's, and a
summary whose ``passed_limit`` counts the seeds on which the control (or
the fault) passed: it has to be 0.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--bits", type=int, default=4)
    p.add_argument("--fault", default=None,
                   help="a fault of faults.py planted under the timed path "
                        "(its readings instead of the control's)")
    args = p.parse_args(argv)
    import torch

    from portbench import core
    from portbench.cell import run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from portbench import faults

    bench = core.with_deferred(core.benchmark())
    spec = core.cell(bench, args.workload)
    kinds = (faults.TRAINING if core.data_file("traffic", spec["traffic"])
             ["loop"] == "train" else faults.SERVING)
    fault = kinds[args.fault] if args.fault else None
    program, control, verdicts = [], [], []
    for seed in args.seeds:
        t = time.perf_counter()
        res = run_cell(bench, args.workload, seed, args.seconds, False,
                       torch.device("cuda", 0), t, fault=fault,
                       control_bits=None if fault else args.bits)
        program.append(res["readings"])
        control.append(res["control"])
        verdicts.append(res.get("control_correct") if control[-1]
                        else res["correct"])
        # "correct": the harness's decision on the program's (or the
        # fault's) answers; "control_correct": the same test on the
        # control's; a control or a fault has to read false
        print(json.dumps({"seed": seed, "program": program[-1],
                          "correct": res["correct"],
                          "control": control[-1],
                          "control_correct": res.get("control_correct"),
                          "failed": res["failed"],
                          "metrics": {k: v for k, (v, _) in
                                      res["metrics"].items()}}), flush=True)
    print(json.dumps({
        "workload": args.workload, "bits": args.bits,
        "seeds": len(args.seeds), "fault": args.fault,
        "passed_limit": sum(bool(v) for v in verdicts),
        "program_highest": {k: max(p[k] for p in program)
                            for k in program[0]},
        "control_least": ({k: min(c[k] for c in control) for k in control[0]}
                          if control[0] else None)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
