"""Geometric-consistency check between a reference and a source depth map.

The port's counterpart of ``casmvsnet_pl_tpu/fusion/consistency.py``, in
torch ops on the tensors' own device. It follows the arithmetic of the JAX
package's native kernel (``native/fusion_kernels.cc::geo_consistency``):
each reference pixel, lifted by its depth, is projected into the source
view in float64; the source coordinates are rounded to float32; the source
depth and colour are sampled there with float32 bilinear taps, each tap
outside the image contributing zero and a non-finite coordinate giving
zero; the sampled depth is reprojected into the reference view in float64.
A pixel is accepted when the round trip lands within 1 px (squared error
< 1) and 1 % relative depth; accepted pixels return the reprojected depth
and the source colour, rejected ones 0.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def relative_projection(P_world2from: np.ndarray, P_world2to: np.ndarray
                        ) -> list[float]:
    """The top 3 rows of ``P_to @ inv(P_from)`` in float64, row-major."""
    P = (np.asarray(P_world2to, np.float64)
         @ np.linalg.inv(np.asarray(P_world2from, np.float64)))[:3]
    return [float(v) for v in P.reshape(-1)]


def _project(P: list[float], x: Tensor, y: Tensor, d: Tensor):
    """(P @ [x d, y d, d, 1]) in float64, as the native kernel sums it."""
    hx, hy = x * d, y * d
    return tuple(P[4 * r] * hx + P[4 * r + 1] * hy + P[4 * r + 2] * d
                 + P[4 * r + 3] for r in range(3))


def sample_bilinear_zero(img: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Bilinear samples of ``img`` (H, W, C) float32 at float32 pixel
    coordinates ``x``, ``y`` (any shape S) -> (*S, C); taps outside the
    image contribute zero, a non-finite coordinate gives zero."""
    H, W, C = img.shape
    ok = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(ok, x, 0.0)
    y = torch.where(ok, y, 0.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    # clamped before the integer conversion: far taps stay out of range
    x0 = x0.clamp(-2, W + 1).long()
    y0 = y0.clamp(-2, H + 1).long()
    flat = img.reshape(H * W, C)
    acc = torch.zeros(x.shape + (C,), dtype=img.dtype, device=img.device)
    for dy in (0, 1):
        yy = y0 + dy
        wy = fy if dy else 1.0 - fy
        for dx in (0, 1):
            xx = x0 + dx
            wx = fx if dx else 1.0 - fx
            valid = ok & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            w = torch.where(valid, wy * wx, 0.0)
            acc = acc + w[..., None] * flat[idx]
    return acc


def check_geo_consistency(depth_ref: Tensor, P_world2ref: np.ndarray,
                          depth_src: Tensor, P_world2src: np.ndarray,
                          image_src: Tensor):
    """depth_ref, depth_src: (H, W) float32; image_src: (H, W, 3) float32,
    all on one device; P_*: (4, 4) world-to-camera projections.

    Returns (depth_ref_reproj (H, W) float32, mask_geo (H, W) bool,
    image_src2ref (H, W, 3) float32) on that device.
    """
    H, W = depth_ref.shape
    dev = depth_ref.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev),
                          indexing="ij")
    d = depth_ref.double()
    qx, qy, qz = _project(relative_projection(P_world2ref, P_world2src),
                          x, y, d)
    xs, ys = (qx / qz).float(), (qy / qz).float()
    ds = sample_bilinear_zero(depth_src[..., None], xs, ys)[..., 0]

    rx, ry, rz = _project(relative_projection(P_world2src, P_world2ref),
                          xs.double(), ys.double(), ds.double())
    xr, yr = rx / rz, ry / rz
    pix2 = (xr - x) ** 2 + (yr - y) ** 2
    rel = ((rz - d) / d).abs()
    mask = (torch.isfinite(pix2) & torch.isfinite(rel) & (pix2 < 1.0)
            & (rel < 0.01))
    depth_reproj = torch.where(mask, rz.float(), 0.0)
    image = torch.where(mask[..., None],
                        sample_bilinear_zero(image_src, xs, ys), 0.0)
    return depth_reproj, mask, image
