"""One LoFTR encoder layer of TransMVSNet's Feature Matching Transformer
(``models/fmt.py``): x + norm2(mlp([x, norm1(merge(attention(x,
source)))])), Linear layers without bias, LoFTR's linear attention
(Sun et al., LoFTR, CVPR 2021).

A layer's weights are ten tensors, in this order: ``q_proj``, ``k_proj``,
``v_proj``, ``merge`` (C x C), ``mlp.0`` (2C x 2C), ``mlp.2`` (C x 2C),
``norm1``'s weight and bias, ``norm2``'s weight and bias (C).

On CUDA tensors that need no gradient (eval) :func:`fmt_layer` is the
kernel ``kernels/fmt_layer.py::fmt_layer_cuda``, which updates the views in
place and has no backward. Where a gradient is needed (training), and on
CPU tensors, it is :func:`plain_fmt_layer`, differentiated by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.fmt_layer import fmt_layer_cuda

Tensor = torch.Tensor
EPS = 1e-6              # the attention's normalizer
LN_EPS = 1e-5           # nn.LayerNorm's


def linear_attention(q: Tensor, k: Tensor, v: Tensor, eps: float = EPS
                     ) -> Tensor:
    """LoFTR's ``LinearAttention``: phi(x) = elu(x) + 1,
    out = phi(Q) (phi(K)^T V) / (phi(Q) sum_s phi(K_s) + eps), each head
    alone. q (N, L, H, D); k, v (Ns, S, H, D), N a multiple of Ns: source
    batch i serves queries i r .. i r + r - 1 (r = N / Ns). V is divided by
    S before its product and the result multiplied by S after, as LoFTR
    does. Returns (N, L, H, D)."""
    Q, K = F.elu(q) + 1, F.elu(k) + 1
    S = v.shape[1]
    kv = torch.einsum("nshd,nshv->nhdv", K, v / S)
    ksum = K.sum(dim=1)
    r = q.shape[0] // k.shape[0]
    if r > 1:
        kv, ksum = kv.repeat_interleave(r, 0), ksum.repeat_interleave(r, 0)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, ksum) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, kv, z) * S


def plain_fmt_layer(x: Tensor, source: Tensor, weights, nhead: int
                    ) -> Tensor:
    """The layer's plain version on either device, in x's dtype: x (N, L,
    C), source (Ns, S, C) with N a multiple of Ns (see
    :func:`linear_attention`) -> (N, L, C)."""
    wq, wk, wv, wm, w0, w2, n1w, n1b, n2w, n2b = weights
    N, L, C = x.shape
    Ns, S = source.shape[:2]
    q = F.linear(x, wq).view(N, L, nhead, C // nhead)
    k = F.linear(source, wk).view(Ns, S, nhead, C // nhead)
    v = F.linear(source, wv).view(Ns, S, nhead, C // nhead)
    message = linear_attention(q, k, v).reshape(N, L, C)
    message = F.layer_norm(F.linear(message, wm), (C,), n1w, n1b, LN_EPS)
    message = F.linear(F.relu(F.linear(torch.cat([x, message], dim=2), w0)),
                       w2)
    return x + F.layer_norm(message, (C,), n2w, n2b, LN_EPS)


def plain_fmt_views(views: Tensor, weights, nhead: int, cross: bool
                    ) -> Tensor:
    """:func:`fmt_layer`'s plain version on either device, in views' dtype:
    :func:`plain_fmt_layer` over all B x V views (self) or the B x (V - 1)
    source views against their references (cross), as a new tensor."""
    B, V, L, C = views.shape
    if not cross:
        x = views.reshape(B * V, L, C)
        return plain_fmt_layer(x, x, weights, nhead).view(B, V, L, C)
    src = plain_fmt_layer(views[:, 1:].reshape(B * (V - 1), L, C),
                          views[:, 0], weights, nhead)
    return torch.cat([views[:, :1], src.view(B, V - 1, L, C)], dim=1)


def fmt_layer(views: Tensor, weights, nhead: int, cross: bool) -> Tensor:
    """views (B, V, L, C), the reference view of each scene first -> the
    same: a self layer (``cross`` False) updates every view from itself, a
    cross layer every view but the reference from its scene's reference.
    On the card, where no gradient is needed, the kernel updates the views
    in place (they must be contiguous) and returns them; where one is
    needed, and on the CPU, a new tensor is returned
    (:func:`plain_fmt_views`)."""
    grad = torch.is_grad_enabled() and (
        views.requires_grad or any(w.requires_grad for w in weights))
    if views.is_cuda and not grad:
        return fmt_layer_cuda(views, weights, nhead, cross)
    return plain_fmt_views(views, weights, nhead, cross)
