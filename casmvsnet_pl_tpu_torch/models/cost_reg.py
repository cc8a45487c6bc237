"""3D cost-volume regularization U-Net.

Counterpart of ``casmvsnet_pl_tpu/models/cost_reg.py::CostRegNet``. The JAX
model also has a D-folded execution (``CostRegNetFolded``) for the MXU; the
two share parameters, so this one module serves every cascade level. Names
follow the reference state dict (``conv0..6``, ``conv7|9|11.{0,1}``,
``prob``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.profiling import span
from .blocks import ConvBnAct, ConvTransposeBnAct3D


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv0 = ConvBnAct(in_channels, 8, dims=3)
        self.conv1 = ConvBnAct(8, 16, dims=3, stride=2)
        self.conv2 = ConvBnAct(16, 16, dims=3)
        self.conv3 = ConvBnAct(16, 32, dims=3, stride=2)
        self.conv4 = ConvBnAct(32, 32, dims=3)
        self.conv5 = ConvBnAct(32, 64, dims=3, stride=2)
        self.conv6 = ConvBnAct(64, 64, dims=3)
        self.conv7 = ConvTransposeBnAct3D(64, 32)
        self.conv9 = ConvTransposeBnAct3D(32, 16)
        self.conv11 = ConvTransposeBnAct3D(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) cost volume -> (B, D, H, W) regularized cost.

        D, H and W must be divisible by 8. The NCDHW view of the contiguous
        input is physically NDHWC (channels_last_3d), which cuDNN keeps.
        """
        x = x.permute(0, 4, 1, 2, 3)
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        c = self.conv6(self.conv5(c4))
        c = c4 + self.conv7(c)
        c = c2 + self.conv9(c)
        c = c0 + self.conv11(c)
        with span("cascade.prob"):
            return self.prob(c)[:, 0]
