"""The modulated deformable 3x3 convolution (DCNv2) of TransMVSNet's ARF
(``models/transmvsnet.py``): stride 1, padding 1, no bias, C -> C channels.

For every pixel p and tap k = 3 i + j of the 3x3 grid, the raw output of
the offset-and-mask conv ``om`` (27 channels) gives the offset (dy_k, dx_k)
= (om[2k], om[2k+1]) (DCNv2's layout: cat(o1, o2) is om[0:18]) and the
mask m_k = sigmoid(om[18 + k]); the output is

    y(p) = sum_k W_k m_k x~(p + p_k + (dy_k, dx_k)),

x~ the bilinear sample of x with each of its 4 taps zero outside the image.

On CUDA tensors the forward is the kernel ``kernels/deform_conv.py::
deform_conv_cuda``; it has no backward yet (TransMVSNet's training is not
ported), so a backward through it raises. On CPU tensors it is
:func:`plain_deform_conv`, differentiated by autograd.
"""
from __future__ import annotations

import torch

from ..kernels.deform_conv import deform_conv_cuda

Tensor = torch.Tensor

TAPS = 9


def plain_deform_conv(x: Tensor, offset_mask: Tensor, weight: Tensor
                      ) -> Tensor:
    """``deform_conv``'s plain version on either device, in float32: x (N, C,
    H, W), offset_mask (N, 27, H, W), weight (C_out, C, 3, 3) -> (N, C_out,
    H, W) in x's dtype, channels_last. Each sample is the 4 taps' weighted
    sum (taps outside the image read 0), times the mask, then contracted
    with the weight."""
    N, C, H, W = x.shape
    om = offset_mask.float()
    dy, dx = om[:, 0:18:2], om[:, 1:18:2]                  # (N, 9, H, W)
    mask = torch.sigmoid(om[:, 18:27])
    k = torch.arange(TAPS, device=x.device)
    ki, kj = (k // 3 - 1).float(), (k % 3 - 1).float()
    rows = torch.arange(H, dtype=torch.float32, device=x.device)
    cols = torch.arange(W, dtype=torch.float32, device=x.device)
    sy = rows[None, None, :, None] + ki[None, :, None, None] + dy
    sx = cols[None, None, None, :] + kj[None, :, None, None] + dx
    flat = x.float().permute(0, 2, 3, 1).reshape(N, H * W, C)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    sample = 0.0
    for ty, tx, w in ((y0, x0, (1 - fy) * (1 - fx)),
                      (y0, x0 + 1, (1 - fy) * fx),
                      (y0 + 1, x0, fy * (1 - fx)),
                      (y0 + 1, x0 + 1, fy * fx)):
        inside = (ty >= 0) & (ty <= H - 1) & (tx >= 0) & (tx <= W - 1)
        idx = torch.where(inside, ty * W + tx, torch.zeros_like(ty)).long()
        taps = torch.gather(flat, 1, idx.reshape(N, -1, 1).expand(-1, -1, C))
        w = torch.where(inside, w, torch.zeros_like(w))
        sample = sample + taps * w.reshape(N, -1, 1)       # (N, 9HW, C)
    sample = sample * mask.reshape(N, -1, 1)
    sample = sample.reshape(N, TAPS, H, W, C)
    y = torch.einsum("nkhwc,ock->nhwo", sample,
                     weight.float().reshape(weight.shape[0], C, TAPS))
    return y.to(x.dtype).permute(0, 3, 1, 2)


class _DeformConv(torch.autograd.Function):
    """The kernel forward; no backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, offset_mask, weight):
        return deform_conv_cuda(x, offset_mask, weight)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the deformable conv's kernel has no backward: TransMVSNet's "
            "training (its focal loss and this backward) is not ported yet")


def deform_conv(x: Tensor, offset_mask: Tensor, weight: Tensor) -> Tensor:
    """x (N, C, H, W), offset_mask (N, 27, H, W), weight (C, C, 3, 3) ->
    (N, C, H, W) in x's dtype, channels_last. On the card x and
    offset_mask are made channels_last if they are not, and a backward
    raises."""
    if x.is_cuda:
        return _DeformConv.apply(
            x.contiguous(memory_format=torch.channels_last),
            offset_mask.contiguous(memory_format=torch.channels_last), weight)
    return plain_deform_conv(x, offset_mask, weight)
