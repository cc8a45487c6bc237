"""Cost epilogue of the quad configuration: the 4-tap reduce of gathered
packed-quad rows, then the variance or the groupwise correlation over the
views, and the gradients of both.

Counterpart of ``scripts/kernel_cost_epilogue.py`` (TPU kernels #3-#6):
:func:`plain_variance_epilogue` and :func:`plain_variance_epilogue_bwd` are
written from its ``_var_xla`` and ``_var_bwd_xla``,
:func:`plain_groupwise_epilogue` and :func:`plain_groupwise_epilogue_bwd`
from ``_gw_xla`` and ``_gw_bwd_xla``. They are the plain versions of the
CUDA kernels in ``kernels/cost_epilogue.py``.

The TPU functions take the source views as tuples of (B, D, hw, 4C) rows
and (B, D, hw, 4) weights; here they come stacked into one tensor each:
rows (B, S, D, hw, 4C) and ws (B, S, D, hw, 4) float32, S = V-1 source
views. ref is (B, hw, C). The tap weights stay float32, as the TPU kernel's
``_taps`` keeps them, and every sum is taken in float32.

:func:`variance_epilogue`, :func:`groupwise_epilogue` and their ``_bwd``
counterparts take a CUDA tensor to the kernel and a CPU tensor to the plain
version. On a CUDA tensor they launch the kernel or raise. Each view's
4-tap reduce and its gradients are the plain versions of TPU kernels #7/#8
(``ops/tap_reduce.py``).
"""
from __future__ import annotations

import torch

from ..kernels.cost_epilogue import (groupwise_epilogue_bwd_cuda,
                                     groupwise_epilogue_cuda,
                                     variance_epilogue_bwd_cuda,
                                     variance_epilogue_cuda)
from .tap_reduce import plain_tap_reduce, plain_tap_reduce_bwd

Tensor = torch.Tensor


def _grads_of_rows(rows: Tensor, ws: Tensor, dos: list[Tensor]
                   ) -> tuple[Tensor, Tensor]:
    """d rows (in the rows' dtype) and d ws (f32) of each view's 4-tap
    reduce, given d o_v (:func:`plain_tap_reduce_bwd` view by view)."""
    grads = [plain_tap_reduce_bwd(rows[:, v], ws[:, v], do)
             for v, do in enumerate(dos)]
    return (torch.stack([d for d, _ in grads], 1),
            torch.stack([d for _, d in grads], 1))


def plain_variance_epilogue(ref: Tensor, rows: Tensor, ws: Tensor) -> Tensor:
    """(ref^2 + sum_v o_v^2) / V - ((ref + sum_v o_v) / V)^2, o_v the 4-tap
    reduce of view v's rows. Returns (B, D, hw, C) in ref's dtype."""
    B, S, D, hw, C4 = rows.shape
    C = C4 // 4
    reff = ref.float()[:, None]                              # (B, 1, hw, C)
    s = reff.expand(B, D, hw, C)
    sq = s * s
    for v in range(S):
        o = plain_tap_reduce(rows[:, v], ws[:, v])
        s = s + o
        sq = sq + o * o
    inv = 1.0 / (S + 1)         # multiplied, not divided by, as the kernel
    m = s * inv
    return (sq * inv - m * m).to(ref.dtype)


def plain_variance_epilogue_bwd(ref: Tensor, rows: Tensor, ws: Tensor,
                                grad: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The VJP of :func:`plain_variance_epilogue`. With m = (ref + sum_v
    o_v) / V and gs = grad 2/V: d ref = sum_d gs (ref - m), d o_v = gs (o_v
    - m). Returns (d ref (B, hw, C) f32, d rows in the rows' dtype, d ws
    f32)."""
    S = rows.shape[1]
    reff = ref.float()[:, None]
    os = [plain_tap_reduce(rows[:, v], ws[:, v]) for v in range(S)]
    s = reff
    for o in os:
        s = s + o
    inv = 1.0 / (S + 1)
    m = s * inv
    gs = grad.float() * (2.0 * inv)
    d_ref = (gs * (reff - m)).sum(1)
    d_rows, d_ws = _grads_of_rows(rows, ws, [gs * (o - m) for o in os])
    return d_ref, d_rows, d_ws


def plain_groupwise_epilogue(ref: Tensor, rows: Tensor, ws: Tensor,
                             groups: int) -> Tensor:
    """sum_v mean_{c in g}(o_v[c] ref[c]) / (V-1) per group of C/G
    consecutive channels. Returns (B, D, hw, G) in ref's dtype."""
    B, S, D, hw, C4 = rows.shape
    C = C4 // 4
    k = C // groups
    reff = ref.float()[:, None]
    acc = None
    for v in range(S):
        o = plain_tap_reduce(rows[:, v], ws[:, v])
        p = (o * reff).reshape(B, D, hw, groups, k).sum(-1)
        acc = p if acc is None else acc + p
    return (acc * (1.0 / (k * S))).to(ref.dtype)


def plain_groupwise_epilogue_bwd(ref: Tensor, rows: Tensor, ws: Tensor,
                                 grad: Tensor, groups: int
                                 ) -> tuple[Tensor, Tensor, Tensor]:
    """The VJP of :func:`plain_groupwise_epilogue`. With ge[c] = grad[c //
    k] / (k (V-1)), k = C/G: d ref = sum_d sum_v ge o_v, d o_v = ge ref.
    Returns as :func:`plain_variance_epilogue_bwd`."""
    B, S, D, hw, C4 = rows.shape
    C = C4 // 4
    k = C // groups
    reff = ref.float()[:, None]
    ge = (grad.float() * (1.0 / (k * S))).repeat_interleave(k, dim=-1)
    so = None
    for v in range(S):
        o = plain_tap_reduce(rows[:, v], ws[:, v])
        so = o if so is None else so + o
    d_ref = (ge * so).sum(1)
    d_rows, d_ws = _grads_of_rows(rows, ws, [ge * reff] * S)
    return d_ref, d_rows, d_ws


def variance_epilogue(ref: Tensor, rows: Tensor, ws: Tensor) -> Tensor:
    """TPU kernel #3: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU one. Shapes as :func:`plain_variance_epilogue`."""
    if ref.is_cuda:
        return variance_epilogue_cuda(ref, rows, ws)
    return plain_variance_epilogue(ref, rows, ws)


def variance_epilogue_bwd(ref: Tensor, rows: Tensor, ws: Tensor,
                          grad: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """TPU kernel #4, dispatched as :func:`variance_epilogue`."""
    if ref.is_cuda:
        return variance_epilogue_bwd_cuda(ref, rows, ws, grad)
    return plain_variance_epilogue_bwd(ref, rows, ws, grad)


def groupwise_epilogue(ref: Tensor, rows: Tensor, ws: Tensor,
                       groups: int) -> Tensor:
    """TPU kernel #5, dispatched as :func:`variance_epilogue`."""
    if ref.is_cuda:
        return groupwise_epilogue_cuda(ref, rows, ws, groups)
    return plain_groupwise_epilogue(ref, rows, ws, groups)


def groupwise_epilogue_bwd(ref: Tensor, rows: Tensor, ws: Tensor,
                           grad: Tensor, groups: int
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """TPU kernel #6, dispatched as :func:`variance_epilogue`."""
    if ref.is_cuda:
        return groupwise_epilogue_bwd_cuda(ref, rows, ws, grad, groups)
    return plain_groupwise_epilogue_bwd(ref, rows, ws, grad, groups)
