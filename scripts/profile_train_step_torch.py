"""Training-step device time of the port at the reference training
protocol (640x512, batch 2, 3 views, Adam lr 1e-3) on one NVIDIA GPU.
The port's ``scripts/profile_train_step.py``.

    python3 scripts/profile_train_step_torch.py [--sampling auto|quad|window]
    python3 scripts/profile_train_step_torch.py --device cpu --H 64 --W 96 --iters 2

``entry.train_entry``'s trainer, state and batch (bf16 autocast over
float32 parameters on the card, f32 on the CPU), ``--sampling`` the cost
volume's route: "auto" (K1 forward, K2 backward), "quad" (the cost
epilogue kernels #3/#4) or "window". The first step runs under
``FlopCounterMode`` for the step's convolutions, forward and backward (on
the card with the ``prob`` convs' forward added from their shapes: the
counter does not see their kernel); then ``utils.profiling.device_time`` times ``trainer.train_step`` (CUDA
events, median of ``--iters`` steps after 2) with the card's peak memory
over them (``device_memory_stats``). Prints the JAX script's line (ms a
step, samples/s), then GFLOP a step (the counted convolutions and the
cost volume's float32 operations, forward and backward, from
``utils/flops.py``), TFLOP/s and the share of the card's bf16 peak. The
JAX script's ``--remat`` has no counterpart: the port keeps no
rematerialization.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from casmvsnet_pl_tpu_torch.entry import train_entry  # noqa: E402
from casmvsnet_pl_tpu_torch.models.cascade import FEATURE_CHANNELS  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.flops import (cost_volume_flops,  # noqa: E402
                                                counted_conv_flops,
                                                peak_flops, prob_conv_flops)
from casmvsnet_pl_tpu_torch.utils.profiling import (  # noqa: E402
    card, device_memory_stats, device_time, measurement_device)

B, V = 2, 3


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sampling", default="auto",
                   choices=("auto", "quad", "window"))
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Returns ms, samples_s, peak_gib (None on the CPU), the FLOP counts,
    tflops and pct_peak (on the card)."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    print("device:", card() if device.type == "cuda" else "cpu", flush=True)
    img_wh = (args.W, args.H)
    trainer, state, batch = train_entry(device, batch=B, img_wh=img_wh,
                                        sampling=args.sampling)
    model = state.model
    conv = counted_conv_flops(model, trainer.train_step, state, batch)
    if device.type == "cuda":     # the prob convs' forward kernel
        for k, n in prob_conv_flops(model, img_wh, B).items():
            conv[k] += n
    cv = cost_volume_flops(model.n_depths, FEATURE_CHANNELS, img_wh, V, B,
                           model.num_groups, backward=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dt = device_time(trainer.train_step, state, batch, iters=args.iters)
    stats = device_memory_stats()
    out = {"ms": dt * 1e3, "samples_s": B / dt,
           "peak_gib": stats[0]["peak_bytes_in_use"] / 2 ** 30 if stats
           else None,
           "conv": conv, "cost_volume": cv,
           "total": sum(conv.values()) + cv}
    print(f"train_step sampling={args.sampling}: {dt * 1e3:.1f} ms "
          f"({B / dt:.2f} samples/s)", flush=True)
    share = "(share of peak: not measured on the CPU)"
    memory = "not measured on the CPU"
    if device.type == "cuda":
        out["tflops"] = out["total"] / dt / 1e12
        out["pct_peak"] = 100 * out["total"] / dt / peak_flops(device)
        share = f"= {out['pct_peak']:.3f}% of the bf16 peak [{card()}]"
        memory = f"{out['peak_gib']:.3f} GiB"
    W, H = img_wh
    print(f"train_step sampling={args.sampling} B={B} {W}x{H}x{V}: peak "
          f"memory {memory}; {out['total'] / 1e9:.3f} GFLOP/step "
          f"(convolutions forward+backward {sum(conv.values()) / 1e9:.3f}, "
          f"cost volume {cv / 1e9:.3f}), "
          f"{out['total'] / dt / 1e12:.3f} TFLOP/s {share}", flush=True)
    return out


if __name__ == "__main__":
    main()
