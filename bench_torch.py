"""Headline benchmark of the PyTorch/CUDA port: depth maps/s on one NVIDIA
GPU at DTU 640x512, 3 views. The port's ``bench.py``.

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # smoke mode: B=1, 64x64, 3 calls

Prints one JSON line per measured batch, B = 1, 4 and 8 in that order;
the LAST line is the summary with ``bench.py``'s keys, metric name and
unit, {"metric", "value", "unit", "vs_baseline"}, where vs_baseline =
maps/s / 4.0, ``bench.py``'s RTX 2080Ti estimate (its docstring derives
it). Every line carries the best value so far, so B=1's line stands when a
later batch fails; the failure still raises (exit code != 0). Once
CASMVS_BENCH_BUDGET_S seconds (300 unless set) have passed, the remaining
batches are skipped. No BENCHMARK.json is written.

The forward is ``entry.entry``'s: the default ``CascadeMVSNet`` in bf16
(f32 on the CPU) with seeded random weights on ``entry.make_inputs``' plane
scene (the rig of ``bench.py::make_inputs``); the cost volume is K1 and
the convolutions cuDNN's, with ``cudnn.benchmark`` off as on the main
path. A batch is timed by ``utils.profiling.device_time``: the median of
16 calls after 2, a pair of CUDA events around each call. stderr also
gives each batch's host time to enqueue one call: where it reaches the
device time (B=1), the forward is launch-bound. B >= 4 runs the whole
batch in one forward: ``bench.py``'s ``chunked_apply`` keeps per-sample
working sets in v5e's VMEM, which the port leaves out.

Before the sweep, stderr gives the card's name and power limit (nvidia-smi)
and the rate of a 4096^3 bf16 ``torch.matmul``, ``bench.py``'s "MXU
reference" line: it tells a card held below its peak from a slow build.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from casmvsnet_pl_tpu_torch.entry import entry
from casmvsnet_pl_tpu_torch.utils.profiling import (call_times, card,
                                                    device_time,
                                                    measurement_device)

METRIC = "depth_maps_per_sec_per_chip_640x512_3views"
BASELINE_MAPS_PER_SEC = 4.0          # RTX 2080Ti estimate, see bench.py
BUDGET_S = float(os.environ.get("CASMVS_BENCH_BUDGET_S", "300"))
# the sweep on the card; on the CPU a smoke test, not a performance statement
SWEEP = {"batches": (1, 4, 8), "img_wh": (640, 512), "iters": 16}
SMOKE = {"batches": (1,), "img_wh": (64, 64), "iters": 3}
WARMUP = 2
MATMUL_N = 4096


def emit(best: float) -> None:
    """Print a summary JSON line; a reader takes the LAST such line."""
    print(json.dumps({
        "metric": METRIC,
        "value": round(best, 3),
        "unit": "maps/s",
        "vs_baseline": round(best / BASELINE_MAPS_PER_SEC, 3),
    }), flush=True)


def matmul_rate(device, n: int = MATMUL_N, iters: int = 32) -> float:
    """FLOP/s of one n^3 bf16 ``torch.matmul`` on ``device`` (median of
    ``iters`` calls)."""
    a = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    return 2 * n ** 3 / device_time(torch.matmul, a, a, iters=iters)


def bench_forward(batch: int, img_wh, iters: int, device) -> dict:
    """One batch's forward: maps/s, and the median device and host ms a
    call over ``iters`` calls after ``WARMUP``."""
    fn, args = entry(device, batch=batch, img_wh=img_wh)
    dev, host = call_times(fn, *args, iters=iters, warmup=WARMUP)
    ms = statistics.median(dev) * 1e3
    return {"maps_s": batch * 1e3 / ms, "ms": ms,
            "host_ms": statistics.median(host) * 1e3}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu, the "
                        "smoke mode")
    return p


def main(argv=None) -> dict:
    """Run the sweep (``SWEEP`` on the card, ``SMOKE`` on the CPU); returns
    {"batches": {batch: bench_forward's dict}, "best": the best maps/s,
    "iters": the timed calls a batch}."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    cfg = SWEEP if device.type == "cuda" else SMOKE
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    if device.type == "cuda":
        print(f"bench: {card()}", file=sys.stderr)
        print(f"bench: matmul reference {matmul_rate(device) / 1e12:.0f} "
              f"TFLOP/s bf16 {MATMUL_N}^3 (published dense peak 989 on an "
              f"H100 SXM at 700 W)", file=sys.stderr)
    t0 = time.time()
    best, results = 0.0, {}
    for batch in cfg["batches"]:
        elapsed = time.time() - t0
        if best > 0.0 and elapsed > BUDGET_S:
            print(f"bench: budget exhausted ({elapsed:.0f}s), skipping "
                  f"batch>={batch}", file=sys.stderr)
            break
        r = results[batch] = bench_forward(batch, cfg["img_wh"],
                                           cfg["iters"], device)
        print(f"bench batch={batch}: {r['maps_s']:.2f} maps/s, "
              f"{r['ms']:.3f} ms/forward ({clock}), host "
              f"{r['host_ms']:.3f} ms a call", file=sys.stderr)
        best = max(best, r["maps_s"])
        emit(best)               # last line wins; never lose batch 1
    return {"batches": results, "best": best, "iters": cfg["iters"]}


if __name__ == "__main__":
    main()
