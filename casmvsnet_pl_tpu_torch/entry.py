"""The port's main path in one call: the cascade inference forward.

Counterpart of ``__graft_entry__.py::entry``: ``CascadeMVSNet`` at its
default config (n_depths 8/32/48, interval ratios 1/2/4, variance cost
volume) on the synthetic plane scene at 640x512 with 3 views, with weights
drawn from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .data.synthetic import PlaneScene
from .models import CascadeMVSNet
from .ops.plane_sweep import build_cost_volume

DEPTH_MIN = 425.0
DEPTH_INTERVAL = 2.65


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv weights (std 1/sqrt(fan_in), as the JAX package's
    flax convs), zero conv biases; BN keeps its identity statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def make_inputs(batch: int, img_wh=(640, 512), n_views: int = 3,
                device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Plane-scene images (B, V, H, W, 3) and projections (B, V-1, 3, 3, 4),
    float32, with the rig of ``bench.py::make_inputs``."""
    scene = PlaneScene(img_wh=tuple(img_wh), n_views=n_views, z0=460.0,
                       baseline=12.0, focal=600.0, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    imgs = torch.from_numpy(imgs).to(device).repeat(batch, 1, 1, 1, 1)
    proj = torch.from_numpy(proj).to(device).repeat(batch, 1, 1, 1, 1)
    return imgs, proj


def entry(device, dtype: torch.dtype | None = None, batch: int = 1,
          img_wh=(640, 512), seed: int = 0):
    """(fn, args): ``fn(*args)`` runs the inference forward and returns
    ``(depth_0 (B, H, W), confidence_2 (B, H/4, W/4))``.

    ``dtype`` is the compute dtype of features and convolutions: bf16 on a
    CUDA device and f32 on the CPU unless given. ``fn`` takes an optional
    ``cost_volume`` in place of :func:`build_cost_volume`.
    """
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = CascadeMVSNet()
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    imgs, proj_mats = make_inputs(batch, img_wh, device=device)

    def fn(model, imgs, proj_mats, cost_volume=build_cost_volume):
        with torch.inference_mode():
            out = model(imgs, proj_mats, DEPTH_MIN, DEPTH_INTERVAL,
                        cost_volume=cost_volume)
        return out["depth_0"], out["confidence_2"]

    return fn, (model, imgs, proj_mats)
