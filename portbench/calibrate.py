"""Readings for the limits of ``correct``: the program's numbers and the
control's, over many seeds, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--seconds 3] [--out calib.jsonl]

Each seed is a run of the cell at its own size and load (``run.py``'s
set-up, a short window, the check), with the control (the reference in
complex64 with TF32 products, ``check.control_model``) read on the same
sampled blocks. Prints a JSON line a seed, with the program's verdict and
the control's (``check.judge_control`` against the cell's limits), then the
largest program reading and the smallest control reading of each number,
and how many seeds each side passed. Needs the card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check, harness
    from portbench.registry import Registry
    from portbench.run import set_cache_dirs

    set_cache_dirs()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    prog, ctl = {}, {}
    passed = {"program": 0, "control": 0, "seeds": 0}
    limits = reg.limits(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = harness.run(reg, args.workload, seed, args.seconds, False,
                              "cuda", time.perf_counter(),
                              lambda m: print(m, file=sys.stderr),
                              control=True)
            nums = {n: v for n, v, _ in res.checks}
            cnums = res.control or {}
            ctl_correct = (check.judge_control(cnums, limits)[0] if cnums
                           else None)
            passed["seeds"] += 1
            passed["program"] += bool(res.correct)
            passed["control"] += bool(ctl_correct)
            line = {"workload": args.workload, "seed": seed,
                    "correct": res.correct, "control_correct": ctl_correct,
                    "program": nums, "control": cnums}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
            for k, v in nums.items():
                prog[k] = max(prog.get(k, 0.0), v)
            for k, v in cnums.items():
                ctl[k] = min(ctl.get(k, float("inf")), v)
            torch.cuda.reset_peak_memory_stats()
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": args.workload, "program_max": prog,
                      "control_min": ctl, "passed": passed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
