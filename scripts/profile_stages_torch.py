"""Per-stage device-time breakdown of the port's cascade forward at the
bench configuration, on one NVIDIA GPU. The port's
``scripts/profile_stages.py``.

    python3 scripts/profile_stages_torch.py [--batch 2] [--groups 8]
    python3 scripts/profile_stages_torch.py --device cpu --H 64 --W 96 --batch 1 --iters 2

Times each stage alone with ``utils.profiling.device_time`` (CUDA events,
median of ``--iters`` calls after 2), in bf16 (f32 on the CPU), under
``torch.inference_mode``, on ``profile_stages.py``'s inputs: uniform
random images and features from ``np.random.RandomState(0)``, identity
projections with an x-translation of 3.0, depths 425 + 2.65 d. The stages
and labels are the JAX script's: ``feature`` over B·V images, then per
level ``warp+cost`` (``build_cost_volume``: K1 on the card) and
``costreg`` (the port's ``CostRegNet``, where the JAX script runs its
D-folded one), and one it lacks, ``softmax+regression``: the softmax over
depth, the soft-argmax and the 4-bin confidence, which the port runs as
separate eager kernels. Then the sum of the stages beside the FULL
cascade on the same images, and maps/s.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from casmvsnet_pl_tpu_torch.entry import (DEPTH_INTERVAL, DEPTH_MIN,  # noqa: E402
                                          init_weights)
from casmvsnet_pl_tpu_torch.models import (CascadeMVSNet, CostRegNet,  # noqa: E402
                                           FeatureNet)
from casmvsnet_pl_tpu_torch.models.cascade import _sum4_confidence  # noqa: E402
from casmvsnet_pl_tpu_torch.ops import (build_cost_volume,  # noqa: E402
                                        depth_regression)
from casmvsnet_pl_tpu_torch.probes.common import default_levels  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.profiling import (card, device_time,  # noqa: E402
                                                    measurement_device)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--groups", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def sweep_inputs(B: int, V: int, D: int, h: int, w: int, device):
    """profile_stages.py's projections (B, V-1, 3, 4), identity with an
    x-translation of 3.0, and depths (B, D, h, w), 425 + 2.65 d."""
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(
        np.float32), (B, V - 1, 1, 1))
    proj[..., 0, 3] = 3.0
    dv = (DEPTH_MIN + DEPTH_INTERVAL * np.arange(D, dtype=np.float32))[
        None, :, None, None] * np.ones((B, D, h, w), np.float32)
    return torch.from_numpy(proj).to(device), torch.from_numpy(dv).to(device)


def module(net, device, dtype):
    init_weights(net, torch.Generator().manual_seed(0))
    return net.to(device=device, dtype=dtype).eval()


def regress(cost, dv):
    """What the cascade does after a level's regularizer."""
    prob = torch.softmax(cost.float(), dim=1)
    return depth_regression(prob, dv), _sum4_confidence(prob, dv.shape[1])


def main(argv=None) -> dict:
    """Returns {label: ms}, with "sum of stages", the FULL cascade's label
    and "maps/s"."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    print("device:", card() if device.type == "cuda" else "cpu", flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    B, V, H, W, G = args.batch, args.views, args.H, args.W, args.groups
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    out = {}

    def t(label, fn, *a):
        dt = device_time(fn, *a, iters=args.iters)
        print(f"{label:42s} {dt * 1e3:8.2f} ms", flush=True)
        out[label] = dt * 1e3
        return dt

    total = 0.0
    with torch.inference_mode():
        net = module(FeatureNet(), device, dtype)
        total += t(f"feature {B * V}x{H}x{W}", net, rand(B * V, H, W, 3))

        sweeps = {}
        for l, C, D, h, w in default_levels((W, H)):
            proj, dv = sweeps[l] = sweep_inputs(B, V, D, h, w, device)
            total += t(f"warp+cost L{l} D{D} {h}x{w} C{C}",
                       lambda fe, pr, d: build_cost_volume(fe, pr, d, G),
                       rand(B, V, h, w, C), proj, dv)

        model = module(CascadeMVSNet(num_groups=G), device, dtype)
        imgs = torch.from_numpy(rng.rand(B, V, H, W, 3).astype(
            np.float32)).to(device)
        proj5 = sweeps[0][0][:, :, None].repeat(1, 1, 3, 1, 1)

        for l, C, D, h, w in default_levels((W, H)):
            cin = G if G > 1 else C
            netc = module(CostRegNet(cin), device, dtype)
            total += t(f"costreg L{l} D{D} {h}x{w} C{cin}", netc,
                       rand(B, D, h, w, cin))
        for l, C, D, h, w in default_levels((W, H)):
            total += t(f"softmax+regression L{l} D{D} {h}x{w}", regress,
                       rand(B, D, h, w), sweeps[l][1])

        print(f"{'sum of stages':42s} {total * 1e3:8.2f} ms", flush=True)
        out["sum of stages"] = total * 1e3
        dt = t(f"FULL cascade {B}x{V}x{H}x{W}",
               lambda m, im, pr: m(im, pr, DEPTH_MIN, DEPTH_INTERVAL)[
                   "depth_0"], model, imgs, proj5)
    print(f"maps/s = {B / dt:.2f}", flush=True)
    out["maps/s"] = B / dt
    return out


if __name__ == "__main__":
    main()
