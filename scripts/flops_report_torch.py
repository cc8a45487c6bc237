"""Share of peak of the port's inference forward: the model's FLOPs over
its measured time on one NVIDIA GPU. The port's ``scripts/flops_report.py``.

    python3 scripts/flops_report_torch.py [--batch 1 4 8] [--iters 16]
    python3 scripts/flops_report_torch.py --device cpu --H 64 --W 96 --iters 2

Per batch (``--batch``, 1 unless given), at 640x512x3 in bf16 through
``entry.entry`` (the default model, K1 for the cost volume): GFLOP per
forward from ``casmvsnet_pl_tpu_torch/utils/flops.py``, split into the
convolutions (counted by ``FlopCounterMode`` over one forward, on the card
with the ``prob`` convs' forward added from their shapes, since the counter
does not see their kernel, and checked equal, to the operation, to the
count from the layer shapes) and the cost volume (its float32 operations,
analytic: the counter does not see K1);
ms per forward (``utils.profiling.device_time``); maps/s; TFLOP/s; its
share of the card's published bf16 dense peak (``utils.flops.peak_flops``)
and of a 4096^3 bf16 ``torch.matmul`` measured in the same run, beside the
card's name and power limit. On the CPU the shares are not measured.

Why this count is not ``scripts/flops_report.py``'s: that script takes
XLA's ``cost_analysis()`` of the JAX forward, which includes the work the
JAX package's D-folded and tap-unrolled regularizers waste by design. At
64x96x3, B=1, XLA counts 8.605 GFLOP where the port's forward has 1.838
GFLOP of convolutions; level 1's ``CostRegNetFolded`` alone is 5.400
against ``CostRegNet``'s 0.699. Only ``FeatureNet`` agrees to the
operation (0.3170304 GFLOP). This count is the model's own work, which any
implementation of CasMVSNet must do, so its share of peak compares them.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import matmul_rate  # noqa: E402
from casmvsnet_pl_tpu_torch.entry import (DEPTH_INTERVAL, DEPTH_MIN,  # noqa: E402
                                          entry)
from casmvsnet_pl_tpu_torch.utils.flops import (analytic_conv_flops,  # noqa: E402
                                                conv_flops, forward_flops,
                                                peak_flops, prob_conv_flops)
from casmvsnet_pl_tpu_torch.utils.profiling import (card, device_time,  # noqa: E402
                                                    measurement_device)

N_VIEWS = 3


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1])
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def report(batch: int, img_wh, iters: int, device, peak, matmul) -> dict:
    """One batch: the counts, ms per forward and the shares; prints its
    line."""
    fn, args = entry(device, batch=batch, img_wh=img_wh)
    model, imgs, proj = args
    counted = conv_flops(model, imgs, proj, DEPTH_MIN, DEPTH_INTERVAL)
    if device.type == "cuda":
        for k, n in prob_conv_flops(model, img_wh, batch).items():
            counted[k] += n
    analytic = analytic_conv_flops(model, img_wh, N_VIEWS, batch)
    if counted != analytic:
        raise AssertionError(f"counted convolutions {counted} differ from "
                             f"the analytic count {analytic}")
    totals = forward_flops(model, img_wh, N_VIEWS, batch)
    conv, cv = totals["conv"], totals["cost_volume"]
    dt = device_time(fn, *args, iters=iters)
    rate = (conv + cv) / dt
    out = {"conv": counted, "conv_total": conv, "cost_volume": cv,
           "total": conv + cv, "ms": dt * 1e3, "maps_s": batch / dt,
           "tflops": rate / 1e12}
    share = "(share of peak: not measured on the CPU)"
    if peak is not None:
        out["pct_peak"] = 100 * rate / peak
        out["pct_matmul"] = 100 * rate / matmul
        share = (f"= {out['pct_peak']:.3f}% of the bf16 peak "
                 f"{peak / 1e12:.0f} TFLOP/s, {out['pct_matmul']:.3f}% of the "
                 f"measured matmul {matmul / 1e12:.1f} TFLOP/s [{card()}]")
    W, H = img_wh
    print(f"batch={batch} {W}x{H}x{N_VIEWS}: {(conv + cv) / 1e9:.3f} "
          f"GFLOP/fwd (convolutions {conv / 1e9:.3f}: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in analytic.items())
          + f"; cost volume {cv / 1e9:.3f}), {dt * 1e3:.3f} ms, "
          f"{batch / dt:.2f} maps/s, {rate / 1e12:.3f} TFLOP/s {share}",
          flush=True)
    return out


def main(argv=None) -> dict:
    """Returns {batch: report's dict}."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    peak = matmul = None
    if device.type == "cuda":
        peak = peak_flops(device)
        matmul = matmul_rate(device)
    return {b: report(b, (args.W, args.H), args.iters, device, peak, matmul)
            for b in args.batch}


if __name__ == "__main__":
    main()
