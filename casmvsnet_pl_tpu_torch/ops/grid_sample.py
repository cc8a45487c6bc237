"""Bilinear sampling at fractional pixel coordinates, in plain PyTorch.

Counterpart of the plain ``grid_sample`` in
``casmvsnet_pl_tpu/ops/grid_sample.py``: 4-tap bilinear interpolation from
floor/floor+1 neighbours, each tap that falls outside the image contributing
zero (per-tap zeros padding: a coordinate half outside the image keeps the
in-image tap's share). Coordinates are unnormalized pixels, float32.

The tap order and the rounding of each product and sum match the CUDA
cost-volume kernels (``csrc/sampling.cuh``), whose plain version this is;
:func:`grid_sample_batched_adjoint` is the backward kernel's scatter.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _taps(xy: Tensor, H: int, W: int):
    """The 4 bilinear taps of each coordinate, in the kernels' order:
    [(flat pixel index, weight)], with weight 0 and index 0 for a tap
    outside the image. xy (B, N, 2) float32."""
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    taps = []
    for yt, xt, wgt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                        (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        # Validity is tested on the float coordinates, so coordinates far
        # outside the int range (or NaN) never wrap into the image.
        valid = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
        zero = torch.zeros_like(xt)
        taps.append((torch.where(valid, yt * W + xt, zero).long(),
                     torch.where(valid, wgt, zero)))
    return taps


def grid_sample_batched(feat: Tensor, xy: Tensor) -> Tensor:
    """feat (B, H, W, C); xy (B, ..., 2) -> (B, ..., C) in float32."""
    B, H, W, C = feat.shape
    out_shape = xy.shape[:-1] + (C,)
    flat = feat.float().reshape(B * H * W, C)
    base = (torch.arange(B, device=feat.device) * (H * W))[:, None]
    out = None
    for idx, w in _taps(xy.reshape(B, -1, 2).float(), H, W):
        t = flat[(idx + base).reshape(-1)].reshape(B, -1, C) * w[..., None]
        out = t if out is None else out + t
    return out.reshape(out_shape)


def grid_sample_batched_adjoint(grad: Tensor, xy: Tensor, height: int,
                                width: int) -> Tensor:
    """The adjoint of :func:`grid_sample_batched` in the features: each
    sample's gradient (B, ..., C) is spread onto its in-image taps with its
    bilinear weights, by a float32 ``index_add_``. Returns (B, H, W, C)
    float32; the coordinates xy (B, ..., 2) get no gradient."""
    B, C = grad.shape[0], grad.shape[-1]
    g = grad.float().reshape(B, -1, C)
    base = (torch.arange(B, device=grad.device) * (height * width))[:, None]
    out = torch.zeros(B * height * width, C, dtype=torch.float32,
                      device=grad.device)
    for idx, w in _taps(xy.reshape(B, -1, 2).float(), height, width):
        out.index_add_(0, (idx + base).reshape(-1),
                       (g * w[..., None]).reshape(-1, C))
    return out.reshape(B, height, width, C)


def grid_sample(feat: Tensor, xy: Tensor) -> Tensor:
    """feat (H, W, C); xy (..., 2) -> (..., C) in float32."""
    return grid_sample_batched(feat[None], xy[None])[0]
