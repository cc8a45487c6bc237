"""CostRegNet's input block at one input channel in eval mode: the 3x3x3
conv 1 -> 8 with zero padding 1 and no bias, BatchNorm with the module's
running statistics, leaky ReLU 0.01 (``models/cost_reg.py``, ``conv0``,
on TransMVSNet's one-group correlation volume).

On CUDA tensors it is the kernel ``kernels/in_conv.py::in_conv_cuda``,
which has no backward: a CUDA tensor that needs a gradient raises, and
``CostRegNet`` sends training (BatchNorm in train mode, or autograd) to
``ConvBnAct``. On CPU tensors it is :func:`plain_in_conv`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.in_conv import in_conv_cuda

Tensor = torch.Tensor


def plain_in_conv(x: Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d) -> Tensor:
    """``in_conv``'s plain version on either device: ``ConvBnAct``'s
    operators in eval mode, as its modules run them."""
    from ..models.blocks import LEAKY_SLOPE   # models/ imports this module
    y = F.conv3d(x, conv.weight, conv.bias, 1, 1)
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    return F.leaky_relu(y, LEAKY_SLOPE)


def in_conv(x: Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d) -> Tensor:
    """x (B, 1, D, H, W) -> (B, 8, D, H, W) in x's dtype; ``conv`` without
    bias (``ConvBnAct``'s), BatchNorm in eval mode (the caller sees to
    ``bn.training`` being False). On the card the output is
    channels_last_3d, as cuDNN leaves the U-Net's activations."""
    if x.is_cuda:
        return in_conv_cuda(x.contiguous(), conv.weight, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var, bn.eps)
    return plain_in_conv(x, conv, bn)
