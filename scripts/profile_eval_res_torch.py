"""Forward device time of the port at the DTU evaluation protocol's
configuration (1152x864, 5 views; the reference measures 0.756 s/view
there on an RTX 2080Ti) on one NVIDIA GPU. The port's
``scripts/profile_eval_res.py``.

    python3 scripts/profile_eval_res_torch.py
    ER_ORDER=auto ER_ITERS=2 python3 scripts/profile_eval_res_torch.py --device cpu --H 64 --W 64

For each sampling in ER_ORDER (comma-separated, "auto,quad" unless set):
``entry.entry``'s default model in bf16 (f32 on the CPU) with that
sampling, on the plane scene of ``profile_eval_res.py`` (focal 1000, 5
views), timed by ``utils.profiling.device_time`` (CUDA events, median of
ER_ITERS calls after 2; 8 unless set). Prints the JAX script's line (ms
a view, views/s, and the ratio to the reference's 756 ms/view), then GFLOP
a view (``utils/flops.py::forward_flops``), TFLOP/s and the share of the
card's bf16 peak.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from casmvsnet_pl_tpu_torch.entry import entry  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.flops import forward_flops, peak_flops  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.profiling import (card, device_time,  # noqa: E402
                                                    measurement_device)

V = 5
FOCAL = 1000.0
REFERENCE_MS = 756.0        # RTX 2080Ti, the reference's notebook


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--H", type=int, default=864)
    p.add_argument("--W", type=int, default=1152)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Returns {sampling: {"ms", "views_s", "gflop", and on the card
    "tflops", "pct_peak"}}."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    print("device:", card() if device.type == "cuda" else "cpu", flush=True)
    W, H = args.W, args.H
    order = os.environ.get("ER_ORDER", "auto,quad").split(",")
    iters = int(os.environ.get("ER_ITERS", "8"))
    out = {}
    for sampling in order:
        fn, fargs = entry(device, img_wh=(W, H), sampling=sampling,
                          n_views=V, focal=FOCAL)
        dt = device_time(fn, *fargs, iters=iters)
        flops = forward_flops(fargs[0], (W, H), V, 1)["total"]
        r = out[sampling] = {"ms": dt * 1e3, "views_s": 1.0 / dt,
                             "gflop": flops / 1e9}
        print(f"eval-res forward {W}x{H} {V} views [{sampling}]: "
              f"{dt * 1e3:.1f} ms/view ({1.0 / dt:.2f} views/s; reference "
              f"2080Ti: 756 ms/view -> {REFERENCE_MS / (dt * 1e3):.1f}x)",
              flush=True)
        share = "(share of peak: not measured on the CPU)"
        if device.type == "cuda":
            r["tflops"] = flops / dt / 1e12
            r["pct_peak"] = 100 * flops / dt / peak_flops(device)
            share = f"= {r['pct_peak']:.3f}% of the bf16 peak [{card()}]"
        print(f"eval-res forward [{sampling}]: {flops / 1e9:.3f} GFLOP/view, "
              f"{flops / dt / 1e12:.3f} TFLOP/s {share}", flush=True)
    return out


if __name__ == "__main__":
    main()
