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

The views run batched through ``ops/fmt_layer.py::fmt_layer``, one call a
layer over one (B, V, L, C) buffer: a self layer takes all B x V views, a
cross layer all B x (V-1) source views against their reference. On the
card each layer is the kernel ``csrc/fmt_layer.cu`` (two launches), which
updates the buffer in place; on the CPU its plain version.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.fmt_layer import fmt_layer
from ..utils.profiling import span

Tensor = torch.Tensor


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


class EncoderLayer(nn.Module):
    """LoFTR's encoder layer's parameters; its arithmetic is
    ``ops/fmt_layer.py`` (x + norm2(mlp([x, norm1(merge(attention(x,
    source)))])), Linear layers without bias)."""

    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.nhead = nhead
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

    def weights(self) -> tuple[Tensor, ...]:
        """The ten tensors in ``ops/fmt_layer.py``'s order."""
        return (self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                self.merge.weight, self.mlp[0].weight, self.mlp[2].weight,
                self.norm1.weight, self.norm1.bias, self.norm2.weight,
                self.norm2.bias)


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
        # a buffer of the FMT's own, which the card's layers update in place
        x = (feats + self.encoding(h, w, feats)).reshape(B, V, h * w, C)
        for b in range(self.blocks):
            with span("fmt.block", block=b):
                for layer, cross in ((self.layers[2 * b], False),
                                     (self.layers[2 * b + 1], True)):
                    x = fmt_layer(x, layer.weights(), layer.nhead, cross)
        return x.view(B, V, h, w, C)
