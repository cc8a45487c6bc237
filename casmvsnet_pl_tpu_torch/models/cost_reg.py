"""3D cost-volume regularization U-Net.

Counterpart of ``casmvsnet_pl_tpu/models/cost_reg.py::CostRegNet``. The JAX
model also has a D-folded execution (``CostRegNetFolded``) for the MXU; the
two share parameters, so this one module serves every cascade level. Names
follow the reference state dict (``conv0..6``, ``conv7|9|11.{0,1}``,
``prob``). The last layer, ``prob``, runs through ``ops/prob_conv.py``:
a kernel of its own on the card, ``F.conv3d`` on the CPU. At one input
channel (TransMVSNet's correlation volume), in eval mode and where no
gradient is needed, the first block, ``conv0``, runs through
``ops/in_conv.py``: conv, BatchNorm and activation in one kernel on the
card, ``conv0``'s own operators on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.in_conv import in_conv
from ..ops.prob_conv import prob_conv
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
        # holds the weight and bias of ops.prob_conv.prob_conv
        self.prob = nn.Conv3d(8, 1, 3, padding=1)

    def _needs_grad(self, x: torch.Tensor) -> bool:
        """Whether autograd would record ``conv0``."""
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.conv0.parameters()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) cost volume -> (B, D, H, W) regularized cost.

        D, H and W must be divisible by 8. The NCDHW view of the contiguous
        input is physically NDHWC (channels_last_3d), which cuDNN keeps.
        """
        x = x.permute(0, 4, 1, 2, 3)
        if x.shape[1] == 1 and not self.conv0.bn.training \
                and not self._needs_grad(x):
            c0 = in_conv(x, self.conv0.conv, self.conv0.bn)
        else:
            c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        c = self.conv6(self.conv5(c4))
        c = c4 + self.conv7(c)
        c = c2 + self.conv9(c)
        c = c0 + self.conv11(c)
        with span("cascade.prob"):
            return prob_conv(c, self.prob.weight, self.prob.bias)
