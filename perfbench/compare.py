"""The numbers that decide ``correct``, each against its limit.

Eval (maps): for each map of the seed's sample, against the reference's
float32 map of the same scene and weights, the mean absolute difference of
``depth_0`` (mm) and of ``confidence_2``, and the 99th percentile of the
per-pixel |difference| of ``depth_0`` (a fault confined to a few percent
of the pixels, which the mean dilutes), each over the same statistic
between the reference's bf16-rounded map and its float32 one; the worst
map's. The raw differences swing tenfold from seed to seed with the
weights' sensitivity (bf16 and fp8 alike); the ratios do not.

Training: over the first steps, which the reference follows,
  - ``loss_gap``: the largest |loss - reference loss| / reference loss;
  - ``grad_gap_median``: the first step's gradient as the optimizer took
    it (worked out from Adam's first moment after one step), leaf by leaf
    | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|), the median
    leaf's; the worst leaf's (``grad_gap_worst``) is read but not compared:
    the gradients of FeatureNet's BatchNorm weights and biases, sums over
    every pixel that cancel, read a tenth and more under bf16 rounding in
    the plain reference itself;
  - ``change_gap``: the parameters' change over the steps, by its worst
    leaf, measured the same way.
Leaves whose reference loss gradient is under a thousandth of the median
leaf's (the cost's bias under the softmax over depth) are left out of both:
only round-off moves them.

Every number is checked as ``value <= limit``; one that is not finite
fails. Each launch count is held exactly to what the cell's path launches.
"""
from __future__ import annotations

import math
import statistics
import sys

import torch

ZERO_GRAD = 1e-3


def _mae(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().mean())


def _p99(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.quantile((a.float() - b.float()).abs().flatten(),
                                0.99))


def map_numbers(depth, conf, ref_depth, ref_conf, bf16_depth, bf16_conf
                ) -> dict:
    """A map's mean absolute differences from the reference's float32 map
    (depth in mm, confidence) and the 99th percentile of its depth's, and
    the same over the reference's own bf16-rounded map's: the
    ``*_vs_bf16`` ratios are compared."""
    d, c = _mae(depth, ref_depth), _mae(conf, ref_conf)
    p = _p99(depth, ref_depth)
    return {"depth_vs_bf16": d / max(_mae(bf16_depth, ref_depth), 1e-30),
            "conf_vs_bf16": c / max(_mae(bf16_conf, ref_conf), 1e-30),
            "depth_p99_vs_bf16": p / max(_p99(bf16_depth, ref_depth), 1e-30),
            "depth_mae_mm": d, "conf_mae": c, "depth_p99_mm": p}


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(got: dict, want: dict, keep) -> list[float]:
    """Each kept leaf's | |got| - |want| | / max(|want|, median |want|),
    sorted; NaN everywhere if one is not finite."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w[k] for k in keep)
    gaps = [abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keep]
    return sorted(gaps) if all(math.isfinite(x) for x in gaps) else \
        [math.nan] * len(gaps)


def kept_leaves(ref_raw_grads: dict) -> list[str]:
    n = _norms(ref_raw_grads)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= ZERO_GRAD * med]


def train_numbers(losses, grads, change, ref: dict) -> dict:
    keep = kept_leaves(ref["raw_grads"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    if not all(math.isfinite(x) for x in losses):
        loss_gap = math.nan
    grad = leaf_gaps(grads, ref["grads"], keep)
    return {"loss_gap": loss_gap,
            "grad_gap_median": statistics.median(grad),
            "change_gap": leaf_gaps(change, ref["change"], keep)[-1],
            # read beside the median, not compared: FeatureNet's BatchNorm
            # leaves read a tenth and more under bf16 (PERF.md)
            "grad_gap_worst": grad[-1]}


def worse(a: float | None, b: float) -> float:
    """The larger of two readings; a reading that is not finite stays."""
    if a is None or not math.isfinite(b):
        return b
    return a if not math.isfinite(a) else max(a, b)


def launch_gaps(launch_checks: dict[str, tuple[str, int]], before: dict,
                after: dict, units: int) -> dict[str, float]:
    """Each launch check's |launches a map or step - expected|: the kernel
    counter's launches between ``before`` and ``after`` over ``units``."""
    return {k: abs((after[c] - before[c]) / max(units, 1) - want)
            for k, (c, want) in launch_checks.items()}


def checks(numbers: dict[str, float], limits: dict[str, float],
           cuda: bool = True) -> dict:
    """{name: {"value", "limit"}} in the limits' order; a number missing
    from ``numbers`` fails. Off the card (the CPU tests) the launch counts
    are not held: the CPU path launches no kernel."""
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]}
            for k in limits if cuda or not k.endswith("_launch_gap")}


def passed(table: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in table.values())


def print_checks(table: dict) -> None:
    """Each number beside its limit, the last lines on standard error."""
    for k, c in table.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
