"""TransMVSNet (Ding et al., arXiv:2111.14600; megvii-research/TransMVSNet)
on the port's cascade, for inference and training.

- The trunk: the port's ``FeatureNet`` (32/16/8 channels at 1/4, 1/2, 1).
- ARF (Sec. 3.4), on each of its three outputs: three modulated deformable
  3x3 convs (DCNv2, ``ops/deform_conv.py``), C -> C without bias, the first
  two each followed by BatchNorm and ReLU. Each has its own
  ``conv_offset_mask``, a 3x3 conv C -> 27 with a bias, whose raw output
  holds the offsets and, through a sigmoid, the masks.
- The FMT (Sec. 3.3, ``models/fmt.py``) on the 1/4 level.
- The pathway: level 1 <- smooth_1(up2(dim_reduction_1(FMT output)) +
  level 1), level 0 <- smooth_2(up2(dim_reduction_2(level 1)) + level 0),
  1x1 and 3x3 convs without bias, x2 bilinear upsampling with aligned
  corners as the port's FPN upsamples.
- The cascade of ``CascadeMVSNet`` (48/32/8 hypotheses coarse to fine),
  on the groupwise correlation with one group (the mean over C of
  ref * src, then the unweighted mean over the source views, where the
  published model weights each view pixel-wise; K1 on the card) and
  ``CostRegNet(1)``; the depth is the winner-take-all hypothesis (the
  largest probability), on which the next level's window is centred, and
  the confidence that probability.

Training (``engine/trainer.py``) takes the model's :meth:`TransMVSNet.
objective`, the focal loss (``losses.py::focal_loss``) over each level's
probability volume and hypotheses, which the forward returns with
``volumes``; the windows stay centred on the detached winner-take-all
depths. On the card the deformable convs' backward is their kernel's
(``ops/deform_conv.py``), the FMT runs its plain layers under autograd
(``ops/fmt_layer.py``) and K2 takes the one-group correlation.
"""
from __future__ import annotations

from typing import Callable, Sequence

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..losses import focal_loss
from ..ops.deform_conv import deform_conv
from ..ops.plane_sweep import build_cost_volume
from ..utils.profiling import span
from .blocks import BatchNorm2d, BN_EPS, BN_MOMENTUM
from .cascade import FEATURE_CHANNELS, CascadeMVSNet
from .cost_reg import CostRegNet
from .feature_net import _up2
from .fmt import FMT

Tensor = torch.Tensor


class DeformConv2d(nn.Module):
    """A modulated deformable 3x3 conv, C -> C, without bias, with its
    offset-and-mask branch."""

    def __init__(self, channels: int, level: int | None = None):
        super().__init__()
        self.level = level      # the cascade level, for the backward's span
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.conv_offset_mask = nn.Conv2d(channels, 27, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        """x (N, C, H, W) (channels_last on the card) -> (N, C, H, W)."""
        return deform_conv(x, self.conv_offset_mask(x), self.weight,
                           self.level)


class ARF(nn.Module):
    """dcn0, bn0, ReLU; dcn1, bn1, ReLU; dcn2."""

    def __init__(self, channels: int, level: int | None = None):
        super().__init__()
        self.dcn0 = DeformConv2d(channels, level)
        self.bn0 = BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dcn1 = DeformConv2d(channels, level)
        self.bn1 = BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.dcn2 = DeformConv2d(channels, level)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn0(self.dcn0(x)))
        x = F.relu(self.bn1(self.dcn1(x)))
        return self.dcn2(x)


class TransMVSNet(CascadeMVSNet):
    def __init__(self, n_depths: Sequence[int] = (8, 32, 48),
                 interval_ratios: Sequence[float] = (1.0, 2.0, 4.0),
                 d_model: int = 32, nhead: int = 8, blocks: int = 4,
                 sampling: str = "auto"):
        super().__init__(n_depths, interval_ratios, num_groups=1,
                         sampling=sampling)
        for l in range(self.levels):
            self.add_module(f"cost_reg_{l}", CostRegNet(1))
        c0, c1, c2 = FEATURE_CHANNELS
        self.arf = nn.ModuleList(ARF(c, l)
                                 for l, c in enumerate(FEATURE_CHANNELS))
        self.fmt = FMT(d_model, nhead, blocks)
        self.dim_reduction_1 = nn.Conv2d(c2, c1, 1, bias=False)
        self.dim_reduction_2 = nn.Conv2d(c1, c0, 1, bias=False)
        self.smooth_1 = nn.Conv2d(c1, c1, 3, padding=1, bias=False)
        self.smooth_2 = nn.Conv2d(c0, c0, 3, padding=1, bias=False)

    def features(self, imgs: Tensor) -> dict[str, Tensor]:
        """imgs: (B, V, H, W, 3) -> {'level_l': (B, V, h_l, w_l, C_l)}: the
        trunk, ARF on each level, the FMT on level 2 and the pathway."""
        B, V, H, W, _ = imgs.shape
        dtype = self.feature.toplayer.weight.dtype
        trunk = self.feature(imgs.reshape(B * V, H, W, 3).to(dtype))
        # NCHW views of the channels-last outputs
        lv = [trunk[f"level_{l}"].permute(0, 3, 1, 2)
              for l in range(self.levels)]
        for l in range(self.levels):
            with span("cascade.arf", level=l):
                lv[l] = self.arf[l](lv[l])
        h, w = lv[2].shape[-2:]
        with span("cascade.fmt", tokens=B * V * h * w):
            f2 = self.fmt(lv[2].permute(0, 2, 3, 1).reshape(B, V, h, w, -1))
        f2 = f2.reshape(B * V, h, w, -1).permute(0, 3, 1, 2)
        f1 = self.smooth_1(_up2(self.dim_reduction_1(f2)) + lv[1])
        f0 = self.smooth_2(_up2(self.dim_reduction_2(f1)) + lv[0])
        return {f"level_{l}": f.permute(0, 2, 3, 1).contiguous().reshape(
                    B, V, *f.shape[2:], f.shape[1])
                for l, f in enumerate((f0, f1, f2))}

    def default_cost_volume(self) -> Callable:
        """The groupwise correlation with one group, by kind."""
        return functools.partial(build_cost_volume, sampling=self.sampling,
                                 kind="groupwise")

    def depth_and_confidence(self, prob: Tensor, depth_values: Tensor
                             ) -> tuple[Tensor, Tensor]:
        """Winner-take-all: the hypothesis of the largest probability, and
        that probability."""
        conf, idx = prob.max(dim=1)
        depth = torch.gather(depth_values, 1, idx[:, None])[:, 0]
        return depth, conf

    def objective(self, results: dict[str, Tensor], depths: dict[str, Tensor],
                  masks: dict[str, Tensor], levels: int = 3,
                  distributed: bool = False) -> Tensor:
        """The training loss: the focal loss of each level's probability
        volume at the hypothesis nearest the ground truth
        (``losses.py::focal_loss``; ``results`` from a forward with
        ``volumes``)."""
        return focal_loss(results, depths, masks, levels, distributed)
