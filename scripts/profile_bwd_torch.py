"""Backward-pass breakdown of the port at the bench configuration: which
stage dominates training? The port's ``scripts/profile_bwd.py``.

    python3 scripts/profile_bwd_torch.py [--batch 2] [--iters 8]
    python3 scripts/profile_bwd_torch.py --device cpu --H 64 --W 96 --batch 1 --iters 2

Times the gradient of a sum of squares through each stage alone (forward
and backward; ``utils.profiling.device_time``, CUDA events, median of
``--iters`` calls after 2), so a stage's backward is its line here less
its forward from ``scripts/profile_stages_torch.py``. As a train step runs
them: float32 parameters in train mode (batch statistics) under bf16
autocast on the card (f32 on the CPU). The stages and labels are the JAX
script's: ``feature fwd+bwd`` (the gradient for every parameter),
``warp+cost L{l} fwd+bwd`` (``build_cost_volume`` in the compute dtype,
the gradient for the features: K1 then K2 on the card) and ``costreg L{l}
fwd+bwd`` (the port's ``CostRegNet``, the gradient for its input), on
``profile_bwd.py``'s inputs (``np.random.RandomState(0)``, identity
projections with an x-translation of 3.0, depths 425 + 2.65 d).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from casmvsnet_pl_tpu_torch.entry import init_weights  # noqa: E402
from casmvsnet_pl_tpu_torch.models import CostRegNet, FeatureNet  # noqa: E402
from casmvsnet_pl_tpu_torch.ops import build_cost_volume  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.profiling import (card, device_time,  # noqa: E402
                                                    measurement_device)
from casmvsnet_pl_tpu_torch.probes.common import default_levels  # noqa: E402
from profile_stages_torch import sweep_inputs  # noqa: E402

V = 3


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Returns {label: ms}."""
    args = parser().parse_args(argv)
    device = measurement_device(args.device)
    print("device:", card() if device.type == "cuda" else "cpu", flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    B, H, W = args.batch, args.H, args.W
    rng = np.random.RandomState(0)

    def rand(*shape, dtype=dtype):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    def autocast():
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=dtype)

    def trained(net):
        init_weights(net, torch.Generator().manual_seed(0))
        return net.to(device).train()

    out = {}

    def t(label, fn, *a):
        dt = device_time(fn, *a, iters=args.iters)
        print(f"{label:46s} {dt * 1e3:8.2f} ms", flush=True)
        out[label] = dt * 1e3

    net = trained(FeatureNet())
    params = list(net.parameters())

    def feature(x):
        with autocast():
            feats = net(x)
        loss = sum((o.float() ** 2).sum() for o in feats.values())
        return torch.autograd.grad(loss, params)[0].sum()

    t("feature fwd+bwd", feature, rand(B * V, H, W, 3, dtype=torch.float32))

    for l, C, D, h, w in default_levels((W, H)):
        proj, dv = sweep_inputs(B, V, D, h, w, device)

        def cost(fe, pr, d):
            fe = fe.detach().requires_grad_()
            loss = (build_cost_volume(fe, pr, d, 1).float() ** 2).sum()
            return torch.autograd.grad(loss, fe)[0].float().sum()

        t(f"warp+cost L{l} fwd+bwd", cost, rand(B, V, h, w, C), proj, dv)

    for l, C, D, h, w in default_levels((W, H)):
        netc = trained(CostRegNet(C))

        def costreg(x, netc=netc):
            x = x.detach().requires_grad_()
            with autocast():
                y = netc(x)
            loss = (y.float() ** 2).sum()
            return torch.autograd.grad(loss, x)[0].float().sum()

        t(f"costreg L{l} fwd+bwd", costreg, rand(B, D, h, w, C))
    return out


if __name__ == "__main__":
    main()
