"""Weighted 4-tap reduce of gathered packed-quad rows, and its VJP.

Counterpart of ``scripts/kernel_tap_reduce.py::weighted_tap_reduce`` (TPU
kernels #7 and #8): :func:`plain_tap_reduce` is written from its
``_xla_reduce``, :func:`plain_tap_reduce_bwd` from the CPU branch of its
``_vjp_bwd``. They are the plain versions of the CUDA kernels in
``kernels/tap_reduce.py``, and the cost epilogue's plain versions
(``ops/cost_epilogue.py``) reduce their taps with them.

One row of 4C channels holds a sample's 2x2 bilinear support in
``pack_quad``'s tap order:

    out[n, c]          = sum_q w[n, q] * rows[n, q*C + c]
    d rows[n, q*C + c] = w[n, q] * g[n, c]
    d w[n, q]          = sum_c rows[n, q*C + c] * g[n, c]

The TPU function takes w as (4, N), tap-major; here it is (N, 4), as
``quad_weights`` makes it. The weights stay float32 and every sum is taken
in float32; d rows is rounded once to the rows' dtype.

:func:`tap_reduce` and :func:`tap_reduce_bwd` take a CUDA tensor to the
kernel and a CPU tensor to the plain version. On a CUDA tensor they launch
the kernel or raise. The kernels take (N, 4C) rows: a caller flattens any
leading batch dimensions.
"""
from __future__ import annotations

import torch

from ..kernels.tap_reduce import tap_reduce_bwd_cuda, tap_reduce_cuda

Tensor = torch.Tensor


def plain_tap_reduce(rows: Tensor, w: Tensor) -> Tensor:
    """(..., 4C) rows of any float dtype x (..., 4) f32 weights -> (..., C)
    f32, the taps added in order."""
    C = rows.shape[-1] // 4
    r = rows.float()
    o = r[..., :C] * w[..., 0:1]
    for q in range(1, 4):
        o = o + r[..., q * C:(q + 1) * C] * w[..., q:q + 1]
    return o


def plain_tap_reduce_bwd(rows: Tensor, w: Tensor, g: Tensor
                         ) -> tuple[Tensor, Tensor]:
    """The VJP of :func:`plain_tap_reduce` for the gradient g (..., C) of
    its output. Returns (d rows in the rows' dtype, d w (..., 4) f32)."""
    C = rows.shape[-1] // 4
    r = rows.float()
    g = g.float()
    d_rows = torch.cat([g * w[..., q:q + 1] for q in range(4)], -1)
    d_w = torch.stack([(r[..., q * C:(q + 1) * C] * g).sum(-1)
                       for q in range(4)], -1)
    return d_rows.to(rows.dtype), d_w


def tap_reduce(rows: Tensor, w: Tensor) -> Tensor:
    """TPU kernel #7: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU one. rows (N, 4C), w (N, 4) f32 -> (N, C) f32."""
    if rows.is_cuda:
        return tap_reduce_cuda(rows, w)
    return plain_tap_reduce(rows, w)


def tap_reduce_bwd(rows: Tensor, w: Tensor, g: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """TPU kernel #8, dispatched as :func:`tap_reduce`; g (N, C) f32."""
    if rows.is_cuda:
        return tap_reduce_bwd_cuda(rows, w, g)
    return plain_tap_reduce_bwd(rows, w, g)
