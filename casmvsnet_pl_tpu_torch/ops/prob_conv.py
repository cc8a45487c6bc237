"""CostRegNet's last layer: the 3x3x3 convolution of 8 channels to 1, zero
padding 1 (``models/cost_reg.py``, ``prob``).

On CUDA tensors the forward is the kernel ``kernels/prob_conv.py::
prob_conv_cuda`` and the backward is the ``aten.convolution_backward`` call
that autograd makes for ``nn.Conv3d``, with the weight cast to the input's
dtype as autocast casts it: training runs cuDNN's backward kernels as
before. On CPU tensors it is ``plain_prob_conv`` (``F.conv3d``), the plain
version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.prob_conv import prob_conv_cuda

Tensor = torch.Tensor


class _ProbConv(torch.autograd.Function):
    """The kernel forward, cuDNN's backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return prob_conv_cuda(x, weight, bias)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad_out.unsqueeze(1), x, weight.to(x.dtype), [1], [1, 1, 1],
            [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
            list(ctx.needs_input_grad))
        return (gx, None if gw is None else gw.to(weight.dtype),
                None if gb is None else gb.to(ctx.bias_dtype))


def plain_prob_conv(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """``prob_conv``'s plain version on either device: ``F.conv3d``, as
    ``nn.Conv3d`` runs it."""
    return F.conv3d(x, weight, bias, 1, 1)[:, 0]


def prob_conv(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """x (B, 8, D, H, W), weight (1, 8, 3, 3, 3), bias (1,) -> (B, D, H, W)
    in x's dtype (the parameters may be float32 under autocast). On the
    card x must be in channels_last_3d, as cuDNN leaves the U-Net's
    activations."""
    if x.is_cuda:
        return _ProbConv.apply(x, weight, bias)
    return plain_prob_conv(x, weight, bias)
