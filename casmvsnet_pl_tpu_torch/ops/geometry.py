"""Multi-view geometry ops in PyTorch.

Counterpart of ``casmvsnet_pl_tpu/ops/geometry.py``: plane-sweep projection,
depth-hypothesis windows and soft-argmax depth regression. Layouts follow the
JAX package (channels-last images, (B, D, H, W) hypotheses); coordinate and
depth math is float32 whatever the feature dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> Tensor:
    """Homogeneous pixel grid (3, H*W): rows (x, y, 1), raster order."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)


def project_to_src(proj_mat: Tensor, depth_values: Tensor,
                   height: int, width: int) -> Tensor:
    """Plane-sweep projection of the reference pixel grid into a source view.

    q = R @ p + T / d, xy = q[:2] / q[2], computed multiplied through by d:
    n = (R @ p) * d + T. A sample with n_z <= 1e-7 * d (behind the source
    camera) is sent to (W, H), outside the image, so the sampler returns
    zeros there.

    The rotation is written out term by term, ((r0*x + r1*y) + r2), each
    product and sum rounded separately: the CUDA cost-volume kernel uses
    the same order, so the two agree to the last bit in float32.

    Args:
      proj_mat: (..., 3, 4) src_proj @ inv(ref_proj) for this level.
      depth_values: (..., D, H, W) depth hypotheses.
    Returns:
      (..., D, H, W, 2) unnormalized source-pixel coordinates, float32.
    """
    P = proj_mat.float()
    d = depth_values.float()
    grid = pixel_grid(height, width, device=d.device)
    x, y = grid[0].reshape(height, width), grid[1].reshape(height, width)

    def coef(i, j):                                   # (..., 1, 1, 1)
        return P[..., i, j][..., None, None, None]

    n = []
    for i in range(3):
        rot = coef(i, 0) * x + coef(i, 1) * y + coef(i, 2)
        n.append(rot * d + coef(i, 3))
    nx, ny, nz = n
    behind = nz <= 1e-7 * d
    rden = 1.0 / torch.where(behind, torch.ones_like(nz), nz)
    sx = torch.where(behind, torch.full_like(nx, float(width)), nx * rden)
    sy = torch.where(behind, torch.full_like(ny, float(height)), ny * rden)
    return torch.stack([sx, sy], dim=-1)


def get_depth_values(current_depth: Tensor, n_depths: int,
                     depth_interval) -> Tensor:
    """Hypothesis window centred on the current depth, clamped at 1e-7.

    current_depth: (B, H, W); depth_interval: scalar or (B,).
    Returns (B, D, H, W): max(cur - D/2 * interval, 1e-7) + interval * k.
    """
    current_depth = current_depth.float()
    interval = torch.as_tensor(depth_interval, dtype=torch.float32,
                               device=current_depth.device)
    interval = interval.reshape(-1, 1, 1)             # (B|1, 1, 1)
    depth_min = torch.clamp(current_depth - n_depths / 2 * interval, min=1e-7)
    steps = torch.arange(n_depths, dtype=torch.float32,
                         device=current_depth.device)
    return depth_min[:, None] + interval[:, None] * steps[None, :, None, None]


def initial_depth_values(depth_min, depth_interval, n_depths: int, batch: int,
                         height: int, width: int, device=None) -> Tensor:
    """Uniform sweep for the coarsest level, (B, D, H, W), contiguous.

    ``depth_min`` and ``depth_interval`` are scalars or (B,) tensors.
    """
    dmin = torch.as_tensor(depth_min, dtype=torch.float32,
                           device=device).expand(batch)
    dint = torch.as_tensor(depth_interval, dtype=torch.float32,
                           device=device).expand(batch)
    steps = torch.arange(n_depths, dtype=torch.float32, device=dmin.device)
    vals = dmin[:, None] + dint[:, None] * steps[None]            # (B, D)
    return vals[:, :, None, None].expand(batch, n_depths, height,
                                         width).contiguous()


def depth_regression(prob: Tensor, depth_values: Tensor) -> Tensor:
    """Soft-argmax depth sum_d p_d * d_d, accumulated in float32.

    prob: (B, D, H, W); depth_values: (B, D, H, W) or (D,). Returns (B, H, W)
    in depth_values' dtype.
    """
    if depth_values.ndim == 1:
        depth_values = depth_values[None, :, None, None]
    acc = torch.sum(prob.float() * depth_values.float(), dim=1)
    return acc.to(depth_values.dtype)


def resize_bilinear(x: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """Bilinear resize, align_corners=True, channels-last (..., H, W, C)."""
    h, w, c = x.shape[-3:]
    if (h, w) == tuple(out_hw):
        return x
    lead = x.shape[:-3]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_hw[0], out_hw[1], c)


def upsample2x(x: Tensor) -> Tensor:
    """x2 bilinear upsample (align_corners=True), channels-last."""
    return resize_bilinear(x, (2 * x.shape[-3], 2 * x.shape[-2]))
