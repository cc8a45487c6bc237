"""FPN feature extractor.

Counterpart of ``casmvsnet_pl_tpu/models/feature_net.py`` (the plain,
non-width-folded branches). Three strided stages (8/16/32 channels at 1, 1/2
and 1/4 resolution), a top-down pathway with lateral 1x1 convs and x2
bilinear upsampling (align_corners), then 3x3 smoothing to 16 and 8
channels. Names follow the reference state dict (``conv0.0`` ... ``smooth0``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBnAct


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode="bilinear", align_corners=True)


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnAct(3, 8), ConvBnAct(8, 8))
        self.conv1 = nn.Sequential(ConvBnAct(8, 16, kernel_size=5, stride=2,
                                             pad=2),
                                   ConvBnAct(16, 16), ConvBnAct(16, 16))
        self.conv2 = nn.Sequential(ConvBnAct(16, 32, kernel_size=5, stride=2,
                                             pad=2),
                                   ConvBnAct(32, 32), ConvBnAct(32, 32))
        self.toplayer = nn.Conv2d(32, 32, 1)
        self.lat1 = nn.Conv2d(16, 32, 1)
        self.lat0 = nn.Conv2d(8, 32, 1)
        self.smooth1 = nn.Conv2d(32, 16, 3, padding=1)
        self.smooth0 = nn.Conv2d(32, 8, 3, padding=1)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, H, W, 3) -> {'level_0': (B, H, W, 8),
        'level_1': (B, H/2, W/2, 16), 'level_2': (B, H/4, W/4, 32)}.

        Runs in channels_last memory format: the NCHW views below are
        physically NHWC, so the outputs come back contiguous channels-last.
        """
        x = x.permute(0, 3, 1, 2)
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        feat2 = self.toplayer(c2)
        feat1 = _up2(feat2) + self.lat1(c1)
        feat0 = _up2(feat1) + self.lat0(c0)
        feats = {"level_0": self.smooth0(feat0),
                 "level_1": self.smooth1(feat1),
                 "level_2": feat2}
        return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in feats.items()}
