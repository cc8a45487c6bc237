"""Plane-sweep cost volumes: variance and groupwise correlation.

Counterpart of ``casmvsnet_pl_tpu/ops/plane_sweep.py::build_cost_volume``.
A CUDA tensor goes to the fused CUDA kernel (``kernels/cost_volume.py``),
which projects, samples and combines in one pass and writes only the
finished volume. A CPU tensor goes to :func:`plain_cost_volume`, the
kernel's plain PyTorch version: project, sample each source view, combine.

The TPU package's sampler tables (quad, block, window, patch) and the
group-fit fallback chain exist because the TPU gather engine charges per
row; neither path here needs them.
"""
from __future__ import annotations

import torch

from ..kernels.cost_volume import cost_volume_cuda
from .geometry import project_to_src
from .grid_sample import grid_sample_batched

Tensor = torch.Tensor


def plain_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                      groups: int = 1) -> Tensor:
    """Cost volume from per-view warps, accumulated in float32.

    feats: (B, V, H, W, C), reference view first; proj_mats: (B, V-1, 3, 4);
    depth_values: (B, D, H, W). Returns (B, D, H, W, C) for groups == 1,
    the variance sum(f^2)/V - (sum(f)/V)^2 with the un-warped reference view
    included; else (B, D, H, W, G), the mean over each group of C/G
    consecutive channels of warped * ref, summed over source views and
    divided by V-1. The result is in the features' dtype.
    """
    B, V, H, W, C = feats.shape
    D = depth_values.shape[1]
    f = feats.float()
    ref = f[:, 0].unsqueeze(1)                               # (B, 1, H, W, C)
    if groups == 1:
        s = ref.expand(B, D, H, W, C)
        sq = s * s
    else:
        if C % groups:
            raise ValueError(f"C={C} is not divisible by groups={groups}")
        acc = feats.new_zeros((B, D, H, W, groups), dtype=torch.float32)
    for v in range(V - 1):
        xy = project_to_src(proj_mats[:, v], depth_values, H, W)
        o = grid_sample_batched(f[:, v + 1], xy)             # (B, D, H, W, C)
        if groups == 1:
            s = s + o
            sq = sq + o * o
        else:
            prod = (o * ref).reshape(B, D, H, W, groups, C // groups)
            acc = acc + prod.sum(-1) * (groups / C)
    # Multiplying by the f32 reciprocal (not dividing) is what the kernel
    # does, and what torch does anyway for a CUDA tensor over a scalar.
    if groups == 1:
        m = s * (1.0 / V)
        out = sq * (1.0 / V) - m * m
    else:
        out = acc * (1.0 / (V - 1))
    return out.to(feats.dtype)


def build_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                      groups: int = 1) -> Tensor:
    """Cost volume dispatcher: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Shapes as in :func:`plain_cost_volume`."""
    if feats.is_cuda:
        return cost_volume_cuda(feats, proj_mats, depth_values, groups)
    return plain_cost_volume(feats, proj_mats, depth_values, groups)
