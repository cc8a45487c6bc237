"""Conv + BatchNorm + leaky ReLU blocks in 2D and 3D.

Counterpart of ``casmvsnet_pl_tpu/models/blocks.py`` (plain forms only).
Module and parameter names follow the reference CasMVSNet state dict
(``conv.weight``, ``bn.*``; ``0.weight`` / ``1.*`` for the transposed
block), so ``casmvsnet_pl_tpu/utils/torch_convert.py::convert_state_dict``
maps a state dict of this package onto the JAX parameters unchanged.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import is_distributed, sync_batch_norm

# InPlaceABN defaults: eps 1e-5, momentum 0.1 (flax 0.9), leaky slope 0.01.
BN_MOMENTUM = 0.1
BN_EPS = 1e-5
LEAKY_SLOPE = 0.01


class _FlaxBatchNorm:
    """BatchNorm whose train-mode running variance is flax's.

    torch's BatchNorm moves ``running_var`` towards the unbiased batch
    variance (times n / (n - 1) for n values per channel); flax's
    ``nn.BatchNorm`` and the JAX package's ``FoldedBatchNorm`` use the
    biased one, which is also what both normalize with. In train mode this
    module runs ``F.batch_norm`` (batch statistics, reduced in float32
    whatever the input dtype, and torch's running update), then takes back
    the unbiased share of the variance update: a per-channel correction,
    with no second pass over the activation. Eval mode is torch's. When
    this process is one rank of several, train mode normalizes over every
    rank's batch (``parallel/sync_bn.py``), as the JAX trainer does over
    its sharded batch.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if is_distributed():
            self.num_batches_tracked.add_(1)
            return sync_batch_norm(x, self.weight, self.bias,
                                   self.running_mean, self.running_var,
                                   self.momentum, self.eps)
        m = self.momentum
        n = x.numel() // x.shape[1]
        # torch's update goes into a copy, which autograd may keep
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, m, self.eps)
        with torch.no_grad():
            # var = (1-m) old + m v n/(n-1); the biased update is var - m v/(n-1)
            self.running_var.copy_(var - (var - (1.0 - m) * self.running_var)
                                   / n)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


class ConvBnAct(nn.Module):
    """conv(bias=False) -> BatchNorm -> leaky_relu(0.01), 2D or 3D."""

    def __init__(self, in_ch: int, out_ch: int, dims: int = 2,
                 kernel_size: int = 3, stride: int = 1, pad: int = 1):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        bn = BatchNorm2d if dims == 2 else BatchNorm3d
        self.conv = conv(in_ch, out_ch, kernel_size, stride=stride,
                         padding=pad, bias=False)
        self.bn = bn(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), LEAKY_SLOPE)


class ConvTransposeBnAct3D(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1, bias=False) -> BN ->
    leaky_relu: shapes double exactly, as in the reference decoder."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            BatchNorm3d(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM))

    def forward(self, x):
        return F.leaky_relu(super().forward(x), LEAKY_SLOPE)
