"""TransMVSNet in plain PyTorch: the reference that decides ``correct`` for
the ``transmvsnet`` configuration.

Written from the paper (Ding et al., TransMVSNet, arXiv:2111.14600, Sec.
3.2-3.4) and LoFTR's encoder layer (Sun et al., CVPR 2021), in float32 and
the NCHW layout, with no kernel and nothing of the port. It reuses
``reference/model.py``'s FeatureNet, CostRegNet, ``project`` and
``sample``; the rest is written out here:

  - the trunk, FeatureNet (32/16/8 channels at 1/4, 1/2, 1);
  - ARF on each of its outputs: three modulated deformable 3x3 convs
    (DCNv2), C -> C without bias, BatchNorm and ReLU after the first two.
    A deformable conv's ``conv_offset_mask`` (3x3, C -> 27, with a bias)
    gives the offsets (dy_k, dx_k) = (om[2k], om[2k+1]) of tap k = 3i + j
    and its mask sigmoid(om[18 + k]); each tap is an explicit bilinear
    gather (``sample``, 4 taps, zero outside the image), times the mask,
    contracted with the weight;
  - the FMT on the 1/4 level: LoFTR's sine positional encoding (d = 32),
    then 4 blocks: ref <- self(ref); for each source view src <- self(src),
    then src <- cross(src, ref). A layer is LoFTR's: Linear q/k/v without
    bias, linear attention phi = elu + 1 (eps 1e-6, V over its length and
    back), ``merge``, LayerNorm, an MLP over [x, message] (64 -> 64, ReLU,
    64 -> 32), LayerNorm, x + message;
  - the pathway: level 1 <- smooth_1(up2(dim_reduction_1(FMT output)) +
    level 1), level 0 <- smooth_2(up2(dim_reduction_2(level 1)) +
    level 0), x2 bilinear with aligned corners;
  - per level, coarse to fine, 48/32/8 hypotheses (CasMVSNet's windows):
    the correlation, the mean over C of src * ref, then over the V - 1
    source views; CostRegNet(1); the softmax over depth; the depth of the
    largest probability (winner-take-all), on which the next level's
    window is centred; the confidence, that probability.

Departures from the published code (megvii-research/TransMVSNet), each
shared with the system under test and listed in the configuration's
``assumed``: the interval ratios 4/2/1 (CasMVSNet's); the ARF as three
DCNs with BatchNorm and ReLU; LoFTR's sine encoding (computed at any
size, not cut at 256); the pathway's upsampling with aligned corners;
the confidence as the largest probability; the trunk and CostRegNet of
kwea123/CasMVSNet_pl (leaky ReLU 0.01). One is a deliberate
simplification of a published mechanism, also stated in the
configuration's ``source``: the unweighted mean over the source views.
The published DepthNet weights each source view's correlation pixel-wise,
from that view's correlation over the depths, before the sum; that
weighting, which favours the views that see a pixel, is left out.

``set_quant(quant)`` rounds the input, weight and output of every
convolution, Linear and deformable conv, the cost volume's input and
output, and the attention's K^T V product, as ``reference/model.py`` does
(None, "bf16", "fp8").
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.model import (BN, QCONVS, CostRegNet, FeatureNet,
                                       QConv2d, depth_window, project, q,
                                       sample, up2)

Tensor = torch.Tensor
CHANNELS = (8, 16, 32)          # the trunk's, level 0 to 2
ATTENTION_EPS = 1e-6


class QLinear(nn.Linear):
    """A Linear layer whose input, weight and output are rounded to
    ``quant``."""
    quant = None

    def forward(self, x):
        y = F.linear(q(x, self.quant), q(self.weight, self.quant), self.bias)
        return q(y, self.quant)


class DeformConv(nn.Module):
    """A modulated deformable 3x3 conv, C -> C, no bias."""
    quant = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, channels, 3, 3))
        self.conv_offset_mask = QConv2d(channels, 27, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        """x (N, C, H, W) -> (N, C, H, W)."""
        N, C, H, W = x.shape
        om = self.conv_offset_mask(x)
        taps = torch.arange(9, device=x.device)
        i = (taps // 3).float() - 1.0
        j = (taps % 3).float() - 1.0
        rows = torch.arange(H, dtype=torch.float32, device=x.device)
        cols = torch.arange(W, dtype=torch.float32, device=x.device)
        y_at = rows[None, None, :, None] + i[None, :, None, None] \
            + om[:, 0:18:2]
        x_at = cols[None, None, None, :] + j[None, :, None, None] \
            + om[:, 1:18:2]
        mask = torch.sigmoid(om[:, 18:27])                 # (N, 9, H, W)
        got = sample(q(x, self.quant), x_at, y_at)          # (N, C, 9, H, W)
        got = got * mask[:, None]
        w = q(self.weight, self.quant).reshape(C, C, 9)
        return q(torch.einsum("nckhw,ock->nohw", got, w), self.quant)


class ARF(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.dcn0 = DeformConv(channels)
        self.bn0 = BN(channels)
        self.dcn1 = DeformConv(channels)
        self.bn1 = BN(channels)
        self.dcn2 = DeformConv(channels)

    def forward(self, x):
        x = F.relu(self.bn0(self.dcn0(x)))
        x = F.relu(self.bn1(self.dcn1(x)))
        return self.dcn2(x)


def sine_position(d_model: int, h: int, w: int, device) -> Tensor:
    """LoFTR's ``PositionEncodingSine`` (``temp_bug_fix``) as (d, h, w):
    channels 0::4, 1::4, 2::4, 3::4 hold sin and cos of the 1-based column,
    sin and cos of the 1-based row, times exp(-2i ln(10000) / (d / 2))."""
    pe = torch.zeros((d_model, h, w), device=device)
    y_position = torch.ones((h, w), device=device).cumsum(0)[None]
    x_position = torch.ones((h, w), device=device).cumsum(1)[None]
    div_term = torch.exp(torch.arange(0, d_model // 2, 2, device=device)
                         .float() * (-math.log(10000.0) / (d_model // 2)))
    div_term = div_term[:, None, None]
    pe[0::4] = torch.sin(x_position * div_term)
    pe[1::4] = torch.cos(x_position * div_term)
    pe[2::4] = torch.sin(y_position * div_term)
    pe[3::4] = torch.cos(y_position * div_term)
    return pe


class EncoderLayer(nn.Module):
    quant = None

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead, self.dim = nhead, d_model // nhead
        self.q_proj = QLinear(d_model, d_model, bias=False)
        self.k_proj = QLinear(d_model, d_model, bias=False)
        self.v_proj = QLinear(d_model, d_model, bias=False)
        self.merge = QLinear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(QLinear(2 * d_model, 2 * d_model,
                                         bias=False), nn.ReLU(),
                                 QLinear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x: Tensor, source: Tensor) -> Tensor:
        """x (B, L, C) attends to source (B, S, C)."""
        B, L, C = x.shape
        query = self.q_proj(x).view(B, L, self.nhead, self.dim)
        key = self.k_proj(source).view(B, -1, self.nhead, self.dim)
        value = self.v_proj(source).view(B, -1, self.nhead, self.dim)
        Q = F.elu(query) + 1
        K = F.elu(key) + 1
        v_length = value.size(1)
        KV = q(torch.einsum("nshd,nshv->nhdv", K, value / v_length),
               self.quant)
        Z = 1 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1))
                 + ATTENTION_EPS)
        message = torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length
        message = self.norm1(self.merge(message.reshape(B, L, C)))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=2)))
        return x + message


class FMT(nn.Module):
    def __init__(self, d_model: int = 32, nhead: int = 8, blocks: int = 4):
        super().__init__()
        self.d_model, self.blocks = d_model, blocks
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead)
                                    for _ in range(2 * blocks))

    def forward(self, views: list[Tensor]) -> list[Tensor]:
        """views [(B, C, h, w)], the reference first -> the same, each
        transformed."""
        B, C, h, w = views[0].shape
        pe = sine_position(self.d_model, h, w, views[0].device)
        tokens = [(v + pe[None]).flatten(2).transpose(1, 2) for v in views]
        ref, srcs = tokens[0], tokens[1:]
        for b in range(self.blocks):
            own, cross = self.layers[2 * b], self.layers[2 * b + 1]
            ref = own(ref, ref)
            srcs = [cross(own(s, s), ref) for s in srcs]
        return [t.transpose(1, 2).reshape(B, C, h, w) for t in [ref] + srcs]


def correlation(feats: Tensor, proj: Tensor, depth: Tensor,
                chunk: int = 8) -> Tensor:
    """feats (B, V, C, H, W), proj (B, V-1, 3, 4), depth (B, D, H, W) ->
    (B, 1, D, H, W): the mean over C of src * ref, averaged over the V - 1
    source views, depth chunk by depth chunk."""
    ref = feats[:, 0, :, None]
    V = feats.shape[1]
    out = []
    for i in range(0, depth.shape[1], chunk):
        d = depth[:, i:i + chunk]
        total = 0.0
        for v in range(1, V):
            x, y = project(proj[:, v - 1], d)
            total = total + (sample(feats[:, v], x, y) * ref).mean(
                1, keepdim=True)
        out.append(total / (V - 1))
    return torch.cat(out, 2)


class TransMVSNet(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.n_depths = tuple(config["n_depths"])
        self.ratios = tuple(config["interval_ratios"])
        self.levels = config["levels"]
        fmt = config["fmt"]
        self.feature = FeatureNet()
        self.arf = nn.ModuleList(ARF(c) for c in CHANNELS)
        self.fmt = FMT(fmt["d_model"], fmt["heads"], fmt["blocks"])
        self.dim_reduction_1 = QConv2d(32, 16, 1, bias=False)
        self.dim_reduction_2 = QConv2d(16, 8, 1, bias=False)
        self.smooth_1 = QConv2d(16, 16, 3, padding=1, bias=False)
        self.smooth_2 = QConv2d(8, 8, 3, padding=1, bias=False)
        for l in range(self.levels):
            self.add_module(f"cost_reg_{l}", CostRegNet(1))
        self.set_quant(None)

    def set_quant(self, quant: str | None) -> None:
        self.quant = quant
        for m in self.modules():
            if isinstance(m, QCONVS + (QLinear, DeformConv, EncoderLayer)):
                m.quant = quant

    def features(self, imgs: Tensor) -> list[Tensor]:
        """imgs (B, V, H, W, 3) -> [level l (B, V, C_l, h_l, w_l)]."""
        B, V, H, W, _ = imgs.shape
        trunk = self.feature(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2))
        lv = [self.arf[l](f) for l, f in enumerate(trunk)]
        c2 = lv[2].reshape(B, V, *lv[2].shape[1:])
        views = self.fmt([c2[:, v] for v in range(V)])
        f2 = torch.stack(views, 1).reshape(B * V, *lv[2].shape[1:])
        f1 = self.smooth_1(up2(self.dim_reduction_1(f2)) + lv[1])
        f0 = self.smooth_2(up2(self.dim_reduction_2(f1)) + lv[0])
        return [f.reshape(B, V, *f.shape[1:]) for f in (f0, f1, f2)]

    def forward(self, imgs: Tensor, proj: Tensor, depth_min: Tensor,
                depth_interval: Tensor) -> dict[str, Tensor]:
        """imgs (B, V, H, W, 3); proj (B, V-1, L, 3, 4) fine to coarse;
        depth_min, depth_interval (B,). Returns {'depth_l', 'confidence_l',
        'prob_l'} for l = 0 .. L-1 (prob_l (B, D_l, h_l, w_l))."""
        B = imgs.shape[0]
        feats = self.features(imgs)
        out, prev = {}, None
        for l in reversed(range(self.levels)):
            f = feats[l]
            h, w = f.shape[-2:]
            D = self.n_depths[l]
            interval = depth_interval * self.ratios[l]
            if prev is None:
                k = torch.arange(D, dtype=torch.float32, device=imgs.device)
                depth = (depth_min[:, None] + interval[:, None] * k)[
                    :, :, None, None].expand(B, D, h, w)
            else:
                up = F.interpolate(prev[:, None], size=(h, w),
                                   mode="bilinear", align_corners=True)[:, 0]
                depth = depth_window(up, D, interval)
            vol = correlation(q(f, self.quant), proj[:, :, l], depth)
            cost = getattr(self, f"cost_reg_{l}")(q(vol, self.quant))
            prob = torch.softmax(cost, 1)
            best, idx = prob.max(1)
            prev = torch.gather(depth, 1, idx[:, None])[:, 0]
            out[f"depth_{l}"] = prev
            out[f"confidence_{l}"] = best
            out[f"prob_{l}"] = prob
        return out
