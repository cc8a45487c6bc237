"""The readings that set a cell's limits: the numbers compared, over many
seeds in one process, for the program, for the control, or for the program
with a fault planted.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3
    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 --mode control
    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 --fault half_batch

``--mode control`` puts the reference, computed in fp8 (float8 e4m3, one
scale a tensor, forward and backward), in the program's place: the
nearest precision below the configuration's bf16. A training cell's
control runs the two references alone, on one card whatever the cell's
cards. Each seed prints one
JSON line ``{"seed", "mode", "fault", "numbers"}``; the last line is the
largest and the smallest reading of each number. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--mode", default="program",
                   choices=("program", "control"))
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    import torch
    from perfbench import compare
    from perfbench.harness import Ctx, load_cell, run_cell
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    cell, config, mix = load_cell(args.workload)
    if args.mode == "control" and mix["kind"].startswith("train_steps"):
        from perfbench.traffic.train_steps import control_numbers
        ctx = Ctx(args.workload, cell, config, mix, seeds, 0.0, False,
                  device, 0.0, "control")
        results = [{"numbers": control_numbers(ctx, s, cell["chips"]),
                    "metrics": {}} for s in seeds]
    else:
        results = run_cell(args.workload, seeds, args.seconds, False,
                           device, mode=args.mode, fault=args.fault)
    worst: dict[str, float] = {}
    least: dict[str, float] = {}
    for seed, r in zip(seeds, results):
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "fault": args.fault, "numbers": r["numbers"],
                          "metrics": r["metrics"]}), flush=True)
        for k, v in r["numbers"].items():
            worst[k] = compare.worse(worst.get(k), v)
            least[k] = v if k not in least else min(least[k], v)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "fault": args.fault, "seeds": len(seeds),
                      "largest": worst, "smallest": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
