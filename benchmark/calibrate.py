"""The readings a cell's limits are set from (`limits/<cell>.json`), on the
card, in one process:

    python -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

For each of `--seeds` it makes a run of the cell as `run.py` does (a short
window of `--seconds`, the frames kept from it drawn from the seed) and
prints the compared numbers: the program's readings. For each of
`--control-seeds` it renders the same frames twice with the reference, once
as it is and once with every float32 result rounded to bfloat16 (the
control, `check.rounded_bf16`), and prints the numbers of the second held
against the first: the control's readings. The last line gives each
number's lower reading (the largest of the program's) and upper reading
(the smallest of the control's). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    program, control = [], []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        out = run.run_cell(cell, seed, args.seconds, False, dev, t, None,
                           log=lambda s: None)
        got = {n: c["value"] for n, c in out["checks"].items()}
        program.append(got)
        print(json.dumps({"program": seed, "frames": out["attempted"],
                          **got, "s": time.perf_counter() - t}), flush=True)
    warm = int(cell.config["warmup"])
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        steps = [warm + k for k in run.kept_steps(seed, cell.config["check"])]
        ref = check.reference_frames(cell, dev, seed, steps)
        low = check.reference_frames(cell, dev, seed, steps, rounded=True)
        got = check.compare(low, ref)
        control.append(got)
        print(json.dumps({"control": seed, **got,
                          "s": time.perf_counter() - t}), flush=True)
    summary = {"cell": cell.name, "seeds": len(program),
               "control_seeds": len(control)}
    for n in check.NUMBERS:
        summary[n] = {
            "lower": max(g[n] for g in program) if program else None,
            "upper": min(g[n] for g in control) if control else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
