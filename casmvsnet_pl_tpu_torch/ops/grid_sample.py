"""Bilinear sampling at fractional pixel coordinates, in plain PyTorch.

Counterpart of the plain ``grid_sample`` in
``casmvsnet_pl_tpu/ops/grid_sample.py``: 4-tap bilinear interpolation from
floor/floor+1 neighbours, each tap that falls outside the image contributing
zero (per-tap zeros padding: a coordinate half outside the image keeps the
in-image tap's share). Coordinates are unnormalized pixels, float32.

The tap order and the rounding of each product and sum match the CUDA
cost-volume kernels (``csrc/sampling.cuh``), whose plain version this is;
:func:`grid_sample_batched_adjoint` is the backward kernel's scatter.

The packed-quad sampler below (:func:`grid_sample_quad`) gathers one row
of a ``pack_quad`` table per sample and reduces it with TPU kernels #7/#8
(``ops/tap_reduce.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .tap_reduce import plain_tap_reduce, tap_reduce, tap_reduce_bwd

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


# ---------------------------------------------------------------------------
# Packed-quad tables: the sampler of the quad configuration
# (``CascadeMVSNet(sampling="quad")``). One gathered row of 4C channels holds
# a sample's whole 2x2 bilinear support; the cost epilogue
# (``ops/cost_epilogue.py``) reduces it with the four tap weights.
# ---------------------------------------------------------------------------

def pack_quad(feat: Tensor) -> Tensor:
    """(..., H, W, C) -> (..., H+1, W+1, 4C) packed 2x2 bilinear supports.

    Counterpart of ``casmvsnet_pl_tpu/ops/grid_sample.py::pack_quad``.
    Entry [yq, xq] holds the taps of floor coordinates (y0, x0) =
    (yq-1, xq-1) in the order (y0x0, y0x1, y1x0, y1x1): one zero guard row
    and column before the map (floor -1) and two after (floor H-1 needs
    row H, and far coordinates clamp onto the guard), so out-of-image taps
    read zeros.
    """
    H, W = feat.shape[-3:-1]
    p = F.pad(feat, (0, 0, 1, 2, 1, 2))
    return torch.cat([p[..., :H + 1, :W + 1, :], p[..., :H + 1, 1:W + 2, :],
                      p[..., 1:H + 2, :W + 1, :], p[..., 1:H + 2, 1:W + 2, :]],
                     dim=-1)


def pack_quad_adjoint(grad: Tensor) -> Tensor:
    """The adjoint of :func:`pack_quad`: (..., H+1, W+1, 4C) -> (..., H, W,
    C), the sum over the four tap blocks of each block's shifted slice
    (the guard cells drop out)."""
    Hq, Wq, C4 = grad.shape[-3:]
    H, W, C = Hq - 1, Wq - 1, C4 // 4
    return (grad[..., 1:, 1:, :C] + grad[..., 1:, :W, C:2 * C]
            + grad[..., :H, 1:, 2 * C:3 * C] + grad[..., :H, :W, 3 * C:])


def quad_weights(xy: Tensor, height: int, width: int):
    """Tap weights and clamped quad-cell indices for :func:`pack_quad`.

    Counterpart of ``casmvsnet_pl_tpu/ops/grid_sample.py::quad_weights``.
    xy (..., 2) pixel coordinates -> (w4 (..., 4) float32 in pack_quad's
    tap order, zero for a tap outside the image; y0i, x0i int64, the
    floor coordinates + 1 clamped into [0, H] x [0, W]). A far coordinate
    clamps onto a guard cell and carries zero weights, so it never aliases
    onto a real texel. The clamp is taken on the float coordinate, so
    coordinates beyond the integer range saturate (and NaN goes to 0).
    """
    x, y = xy[..., 0].float(), xy[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    v_x0 = (x0 >= 0) & (x0 < width)
    v_x1 = (x0 + 1 >= 0) & (x0 + 1 < width)
    v_y0 = (y0 >= 0) & (y0 < height)
    v_y1 = (y0 + 1 >= 0) & (y0 + 1 < height)
    zero = torch.zeros_like(x)
    w4 = torch.stack([torch.where(v_y0 & v_x0, wy0 * wx0, zero),
                      torch.where(v_y0 & v_x1, wy0 * wx1, zero),
                      torch.where(v_y1 & v_x0, wy1 * wx0, zero),
                      torch.where(v_y1 & v_x1, wy1 * wx1, zero)], dim=-1)
    x0i = torch.clamp(torch.nan_to_num(x0 + 1), 0, width).long()
    y0i = torch.clamp(torch.nan_to_num(y0 + 1), 0, height).long()
    return w4, y0i, x0i


def _quad_gather(feat_quad: Tensor, xy: Tensor, height: int, width: int):
    """The flat table (B*(H+1)*(W+1), 4C), the row index (N,) and the tap
    weights (N, 4) f32 of :func:`grid_sample_quad`, and its output shape.
    The batch is folded into the row index, as the JAX function folds it."""
    batched = feat_quad.ndim == 4
    B = feat_quad.shape[0] if batched else 1
    Hq, Wq, C4 = feat_quad.shape[-3:]
    out_shape = xy.shape[:-1] + (C4 // 4,)
    w4, y0i, x0i = quad_weights(xy.reshape(B, -1, 2), height, width)
    base = torch.arange(B, device=xy.device)[:, None] * (Hq * Wq)
    idx = (base + y0i * Wq + x0i).reshape(-1)
    return (feat_quad.reshape(B * Hq * Wq, C4), idx, w4.reshape(-1, 4),
            out_shape)


class _QuadSample(torch.autograd.Function):
    """One row gather from the flat quad table, then the weighted 4-tap
    reduce: TPU kernel #7 forward, #8 backward, through the dispatchers of
    ``ops/tap_reduce.py`` (the CUDA kernels for a CUDA tensor, the plain
    versions for a CPU one).

    It saves the gathered rows, as the JAX ``weighted_tap_reduce`` saves
    them. The backward adds d rows into a float32 table gradient with one
    ``index_add_`` and casts once, as ``_quad_sample_bwd`` scatters in
    float32, and hands d w on to autograd, which carries it through
    ``quad_weights`` to the coordinates.
    """

    @staticmethod
    def forward(ctx, table, idx, w4):
        rows = table.index_select(0, idx)
        ctx.save_for_backward(rows, idx, w4)
        ctx.table_rows = table.shape[0]
        return tap_reduce(rows, w4).to(table.dtype)

    @staticmethod
    def backward(ctx, grad):
        rows, idx, w4 = ctx.saved_tensors
        d_rows, d_w = tap_reduce_bwd(rows, w4, grad.float().contiguous())
        d_table = None
        if ctx.needs_input_grad[0]:
            d_table = torch.zeros((ctx.table_rows, rows.shape[1]),
                                  dtype=torch.float32, device=rows.device)
            d_table.index_add_(0, idx, d_rows.float())
            d_table = d_table.to(rows.dtype)
        return d_table, None, d_w


def grid_sample_quad(feat_quad: Tensor, xy: Tensor, height: int,
                     width: int) -> Tensor:
    """Bilinear sample by one row gather from a :func:`pack_quad` table.

    Counterpart of ``casmvsnet_pl_tpu/ops/grid_sample.py::grid_sample_quad``.
    feat_quad (H+1, W+1, 4C) with xy (..., 2), or batched (B, H+1, W+1, 4C)
    with xy (B, ..., 2), pixel coordinates in the (height, width) frame.
    Returns (..., C) (batched: (B, ..., C)) in feat_quad's dtype, the
    semantics of :func:`grid_sample`. Differentiable with respect to
    feat_quad and xy (see :class:`_QuadSample`). The tap weights stay
    float32 and the taps are summed in float32, rounded once to the
    table's dtype; the JAX function rounds the weights and every partial
    sum to a bf16 table's dtype.
    """
    table, idx, w4, out_shape = _quad_gather(feat_quad, xy, height, width)
    return _QuadSample.apply(table, idx, w4).reshape(out_shape)


def plain_grid_sample_quad(feat_quad: Tensor, xy: Tensor, height: int,
                           width: int) -> Tensor:
    """:func:`grid_sample_quad` in plain PyTorch, differentiated by autograd
    (the gather's own backward included)."""
    table, idx, w4, out_shape = _quad_gather(feat_quad, xy, height, width)
    out = plain_tap_reduce(table.index_select(0, idx), w4)
    return out.to(table.dtype).reshape(out_shape)
