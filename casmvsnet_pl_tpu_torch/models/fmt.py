"""TransMVSNet's Feature Matching Transformer (FMT).

Ding et al., TransMVSNet (arXiv:2111.14600) Sec. 3.3, on LoFTR's encoder
layer and linear attention (Sun et al., LoFTR, CVPR 2021): the sine
positional encoding added to every view's tokens (the coarsest level's
features, one token a pixel), then ``blocks`` blocks, each a self layer over
every view and a cross layer from the reference view into each source view.
The reference view is updated by the self layers alone. Names follow
LoFTR's ``LoFTREncoderLayer`` (``q_proj``, ``k_proj``, ``v_proj``,
``merge``, ``mlp.0``, ``mlp.2``, ``norm1``, ``norm2``); ``layers`` holds
them as the published ``FMT`` does, self and cross alternating.

The views run batched: a self layer takes all B x V views in one call, a
cross layer all B x (V-1) source views against their reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span

Tensor = torch.Tensor
EPS = 1e-6


def sine_encoding(d_model: int, h: int, w: int, device=None) -> Tensor:
    """LoFTR's ``PositionEncodingSine`` (with its ``temp_bug_fix``) at
    (h, w), as (h, w, d_model) float32: channels 4i, 4i+1, 4i+2, 4i+3 hold
    sin(x f_i), cos(x f_i), sin(y f_i), cos(y f_i) of the 1-based column x
    and row y, f_i = exp(-2i ln(10000) / (d_model / 2))."""
    div = torch.exp(torch.arange(0, d_model // 2, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / (d_model // 2)))
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    xs = (x[None, :, None] * div).expand(h, w, -1)
    ys = (y[:, None, None] * div).expand(h, w, -1)
    pe = torch.stack([xs.sin(), xs.cos(), ys.sin(), ys.cos()], dim=-1)
    return pe.reshape(h, w, d_model)


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


class EncoderLayer(nn.Module):
    """LoFTR's encoder layer: x + norm2(mlp([x, norm1(merge(attention(x,
    source)))])), Linear layers without bias."""

    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.nhead, self.dim = nhead, d_model // nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model,
                                           bias=False),
                                 nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x: Tensor, source: Tensor) -> Tensor:
        """x (N, L, C), source (Ns, S, C) with N a multiple of Ns (see
        :func:`linear_attention`) -> (N, L, C)."""
        N, L, C = x.shape
        Ns, S = source.shape[:2]
        q = self.q_proj(x).view(N, L, self.nhead, self.dim)
        k = self.k_proj(source).view(Ns, S, self.nhead, self.dim)
        v = self.v_proj(source).view(Ns, S, self.nhead, self.dim)
        message = linear_attention(q, k, v).reshape(N, L, C)
        message = self.norm1(self.merge(message))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=2)))
        return x + message


class FMT(nn.Module):
    """The positional encoding and ``blocks`` self-then-cross blocks over
    the views of each scene."""

    def __init__(self, d_model: int = 32, nhead: int = 8, blocks: int = 4):
        super().__init__()
        self.d_model, self.blocks = d_model, blocks
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead)
                                    for _ in range(2 * blocks))
        self._pe: dict = {}

    def encoding(self, h: int, w: int, like: Tensor) -> Tensor:
        """The sine encoding at (h, w) in ``like``'s dtype and device, made
        once for each."""
        key = (h, w, like.device, like.dtype)
        if key not in self._pe:
            self._pe[key] = sine_encoding(self.d_model, h, w,
                                          like.device).to(like.dtype)
        return self._pe[key]

    def forward(self, feats: Tensor) -> Tensor:
        """feats (B, V, h, w, C), the reference view first -> the same
        shape, every view transformed."""
        B, V, h, w, C = feats.shape
        L = h * w
        x = (feats + self.encoding(h, w, feats)).reshape(B * V, L, C)
        for b in range(self.blocks):
            with span("fmt.block", block=b):
                x = self.layers[2 * b](x, x)
                views = x.view(B, V, L, C)
                ref = views[:, 0]
                src = views[:, 1:].reshape(B * (V - 1), L, C)
                src = self.layers[2 * b + 1](src, ref)
                x = torch.cat([ref[:, None], src.view(B, V - 1, L, C)],
                              dim=1).reshape(B * V, L, C)
        return x.view(B, V, h, w, C)
