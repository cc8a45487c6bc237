"""The modulated deformable 3x3 convolution (DCNv2) of TransMVSNet's ARF
(``models/transmvsnet.py``): stride 1, padding 1, no bias, C -> C channels.

For every pixel p and tap k = 3 i + j of the 3x3 grid, the raw output of
the offset-and-mask conv ``om`` (27 channels) gives the offset (dy_k, dx_k)
= (om[2k], om[2k+1]) (DCNv2's layout: cat(o1, o2) is om[0:18]) and the
mask m_k = sigmoid(om[18 + k]); the output is

    y(p) = sum_k W_k m_k x~(p + p_k + (dy_k, dx_k)),

x~ the bilinear sample of x with each of its 4 taps zero outside the image.

On CUDA tensors the forward is the kernel ``kernels/deform_conv.py::
deform_conv_cuda`` and the backward the kernel ``deform_conv_bwd_cuda``
(the gradients of x, of the offsets and masks, and of the weight, in one
launch), joined by :class:`_DeformConv`. On CPU tensors it is
:func:`plain_deform_conv`, differentiated by autograd.
"""
from __future__ import annotations

import torch

from ..kernels.deform_conv import deform_conv_bwd_cuda, deform_conv_cuda
from ..utils.profiling import span

Tensor = torch.Tensor

TAPS = 9


def plain_deform_conv(x: Tensor, offset_mask: Tensor, weight: Tensor
                      ) -> Tensor:
    """``deform_conv``'s plain version on either device, in float32 (float64
    for float64 x): x (N, C, H, W), offset_mask (N, 27, H, W), weight
    (C_out, C, 3, 3) -> (N, C_out, H, W) in x's dtype, channels_last. Each
    sample is the 4 taps' weighted sum (taps outside the image read 0),
    times the mask, then contracted with the weight."""
    N, C, H, W = x.shape
    ct = torch.promote_types(x.dtype, torch.float32)
    om = offset_mask.to(ct)
    dy, dx = om[:, 0:18:2], om[:, 1:18:2]                  # (N, 9, H, W)
    mask = torch.sigmoid(om[:, 18:27])
    k = torch.arange(TAPS, device=x.device)
    ki, kj = (k // 3 - 1).to(ct), (k % 3 - 1).to(ct)
    rows = torch.arange(H, dtype=ct, device=x.device)
    cols = torch.arange(W, dtype=ct, device=x.device)
    sy = rows[None, None, :, None] + ki[None, :, None, None] + dy
    sx = cols[None, None, None, :] + kj[None, :, None, None] + dx
    flat = x.to(ct).permute(0, 2, 3, 1).reshape(N, H * W, C)
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
                     weight.to(ct).reshape(weight.shape[0], C, TAPS))
    return y.to(x.dtype).permute(0, 3, 1, 2)


class _DeformConv(torch.autograd.Function):
    """The kernel forward and the kernel backward (CUDA tensors only). The
    inputs are kept for the backward only when a gradient is needed."""

    @staticmethod
    def forward(ctx, x, offset_mask, weight, level):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, offset_mask, weight)
            ctx.level = level
        return deform_conv_cuda(x, offset_mask, weight)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset_mask, weight = ctx.saved_tensors
        with span("arf.backward", level=ctx.level):
            d_x, d_om, d_w = deform_conv_bwd_cuda(
                x, offset_mask, weight,
                grad_out.contiguous(memory_format=torch.channels_last))
        return d_x, d_om, d_w, None


def deform_conv(x: Tensor, offset_mask: Tensor, weight: Tensor,
                level: int | None = None) -> Tensor:
    """x (N, C, H, W), offset_mask (N, 27, H, W), weight (C, C, 3, 3) ->
    (N, C, H, W), channels_last. On the card the three are taken in one
    dtype, autocast's where it is on (else x's), x and offset_mask made
    channels_last if they are not; the backward is the kernel's, recorded
    as an ``arf.backward`` span (attribute ``level``)."""
    if x.is_cuda:
        dtype = torch.get_autocast_dtype("cuda") \
            if torch.is_autocast_enabled("cuda") else x.dtype
        return _DeformConv.apply(
            x.to(dtype).contiguous(memory_format=torch.channels_last),
            offset_mask.to(dtype).contiguous(
                memory_format=torch.channels_last),
            weight.to(dtype), level)
    return plain_deform_conv(x, offset_mask, weight)
