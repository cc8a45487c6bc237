"""Bilinear sampling at fractional pixel coordinates, in plain PyTorch.

Counterpart of the plain ``grid_sample`` in
``casmvsnet_pl_tpu/ops/grid_sample.py``: 4-tap bilinear interpolation from
floor/floor+1 neighbours, each tap that falls outside the image contributing
zero (per-tap zeros padding: a coordinate half outside the image keeps the
in-image tap's share). Coordinates are unnormalized pixels, float32.

The tap order and the rounding of each product and sum match the CUDA
cost-volume kernel (``csrc/cost_volume.cu``), whose plain version this is.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def grid_sample_batched(feat: Tensor, xy: Tensor) -> Tensor:
    """feat (B, H, W, C); xy (B, ..., 2) -> (B, ..., C) in float32."""
    B, H, W, C = feat.shape
    out_shape = xy.shape[:-1] + (C,)
    xy = xy.reshape(B, -1, 2).float()
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = feat.float().reshape(B * H * W, C)
    base = (torch.arange(B, device=feat.device) * (H * W))[:, None]

    def tap(yt, xt, wgt):
        # Validity is tested on the float coordinates, so coordinates far
        # outside the int range (or NaN) never wrap into the image.
        valid = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
        zero = torch.zeros_like(xt)
        idx = torch.where(valid, yt * W + xt, zero).long() + base
        w = torch.where(valid, wgt, zero)
        return flat[idx.reshape(-1)].reshape(B, -1, C) * w[..., None]

    out = (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
           + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))
    return out.reshape(out_shape)


def grid_sample(feat: Tensor, xy: Tensor) -> Tensor:
    """feat (H, W, C); xy (..., 2) -> (..., C) in float32."""
    return grid_sample_batched(feat[None], xy[None])[0]
