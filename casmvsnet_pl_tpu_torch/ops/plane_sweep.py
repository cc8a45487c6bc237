"""Plane-sweep cost volumes: variance and groupwise correlation.

Counterpart of ``casmvsnet_pl_tpu/ops/plane_sweep.py::build_cost_volume``
and of its hand-written VJP (``_patch_sample`` / ``_patch_sample_bwd``).
A CUDA tensor goes to the fused CUDA kernels (``kernels/cost_volume.py``):
K1 projects, samples and combines in one pass and writes only the finished
volume, and K2, its adjoint, is the backward of a ``torch.autograd.Function``.
A CPU tensor goes to :func:`plain_cost_volume`, K1's plain PyTorch version,
and autograd differentiates it; :func:`plain_cost_volume_bwd` is K2's plain
version, written out.

Gradients reach the features only: the projected coordinates are detached,
as the JAX package's ``_patch_view`` stops them, so ``proj_mats`` and
``depth_values`` get none.

The TPU package's sampler tables (quad, block, window, patch) and the
group-fit fallback chain exist because the TPU gather engine charges per
row; neither path here needs them.
"""
from __future__ import annotations

import torch

from ..kernels.cost_volume import cost_volume_bwd_cuda, cost_volume_cuda
from .geometry import project_to_src
from .grid_sample import grid_sample_batched, grid_sample_batched_adjoint

Tensor = torch.Tensor


def _source_coords(proj_mats: Tensor, depth_values: Tensor, H: int,
                   W: int) -> list[Tensor]:
    """Per source view, the (B, D, H, W, 2) sample coordinates, detached."""
    return [project_to_src(proj_mats[:, v], depth_values, H, W).detach()
            for v in range(proj_mats.shape[1])]


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
    for v, xy in enumerate(_source_coords(proj_mats, depth_values, H, W)):
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


def plain_cost_volume_bwd(feats: Tensor, proj_mats: Tensor,
                          depth_values: Tensor, grad_out: Tensor,
                          groups: int = 1) -> Tensor:
    """The gradient of :func:`plain_cost_volume` with respect to feats,
    written out as K2 computes it: recompute the samples o_v, take the
    combine's adjoint, and scatter each source sample's share onto its
    taps (``grid_sample_batched_adjoint``, a float32 ``index_add_``).

    With s = ref + sum_v o_v, m = s / V and g = grad_out:
      variance:  d ref = sum_d g (2/V) (ref - m); d o_v = g (2/V) (o_v - m);
      groupwise: g_c = g[c // k] / (k (V-1)), k = C/G;
                 d ref[c] = sum_d g_c sum_v o_v[c]; d o_v[c] = g_c ref[c].
    Returns (B, V, H, W, C) in the feats dtype, accumulated in float32.
    """
    B, V, H, W, C = feats.shape
    f = feats.float()
    g = grad_out.float()
    ref = f[:, 0].unsqueeze(1)                               # (B, 1, H, W, C)
    coords = _source_coords(proj_mats, depth_values, H, W)
    samples = [grid_sample_batched(f[:, v + 1], xy)
               for v, xy in enumerate(coords)]               # (B, D, H, W, C)
    if groups == 1:
        s = ref
        for o in samples:
            s = s + o
        m = s * (1.0 / V)
        gs = g * (2.0 / V)
        d_ref = (gs * (ref - m)).sum(1)
        d_src = [gs * (o - m) for o in samples]
    else:
        if C % groups:
            raise ValueError(f"C={C} is not divisible by groups={groups}")
        k = C // groups
        gc = (g * (1.0 / (k * (V - 1)))).repeat_interleave(k, dim=-1)
        so = samples[0]
        for o in samples[1:]:
            so = so + o
        d_ref = (gc * so).sum(1)
        d_src = [gc * ref] * (V - 1)
    grad = [d_ref] + [grid_sample_batched_adjoint(d, xy, H, W)
                      for d, xy in zip(d_src, coords)]
    return torch.stack(grad, dim=1).to(feats.dtype)


class _CostVolume(torch.autograd.Function):
    """K1 forward, K2 backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, feats, proj_mats, depth_values, groups):
        ctx.save_for_backward(feats, proj_mats, depth_values)
        ctx.groups = groups
        return cost_volume_cuda(feats, proj_mats, depth_values, groups)

    @staticmethod
    def backward(ctx, grad_out):
        feats, proj_mats, depth_values = ctx.saved_tensors
        d_feats = cost_volume_bwd_cuda(feats, proj_mats, depth_values,
                                       grad_out.contiguous(), ctx.groups)
        return d_feats, None, None, None


def build_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                      groups: int = 1) -> Tensor:
    """Differentiable cost volume: the CUDA kernels (K1 forward, K2
    backward) for a CUDA tensor, the plain version under autograd for a CPU
    tensor. Shapes as in :func:`plain_cost_volume`."""
    if feats.is_cuda:
        return _CostVolume.apply(feats, proj_mats, depth_values, groups)
    return plain_cost_volume(feats, proj_mats, depth_values, groups)
