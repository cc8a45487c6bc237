"""Launch CostRegNet's input block at one input channel, ``csrc/in_conv.cu``:
the 3x3x3 conv 1 -> 8, eval BatchNorm and leaky ReLU 0.01 in one pass.

One wrapper with its own launch count, ``in_conv_cuda``, over the shared
library that ``kernels/library.py`` builds from ``csrc/``. It replaces no
TPU kernel: it takes from cuDNN the conv of TransMVSNet's one-channel
correlation volume, which cuDNN's generic kernel for one input channel ran
with the tensor cores idle, and the BatchNorm and activation passes after
it. Plain version: ``ops/in_conv.py::plain_in_conv``. The wrapper is a raw
launch that records no autograd graph. There is no fallback: on a CUDA
tensor the wrapper launches its kernel or raises.
"""
from __future__ import annotations

import struct

import torch

from .library import DTYPE_CODES, LIBRARY, Kernel, check_device, check_layout

Tensor = torch.Tensor

CHANNELS = 8
WEIGHT_SHAPE = (CHANNELS, 1, 3, 3, 3)


class InConvKernel(Kernel):
    """The input block's forward, ``csrc/in_conv.cu``."""

    def __call__(self, x: Tensor, weight: Tensor, gamma: Tensor,
                 beta: Tensor, mean: Tensor, var: Tensor,
                 eps: float) -> Tensor:
        """x (B, 1, D, H, W) f32|bf16, contiguous; weight (8, 1, 3, 3, 3)
        and BatchNorm's gamma, beta, running mean and running var (8,), all
        of one dtype, f32 or bf16, contiguous. Returns leaky_relu(BN(conv(x)),
        0.01), BN in eval mode with ``eps``: (B, 8, D, H, W) in x's dtype, in
        channels_last_3d, padding 1 on D, H and W, with no autograd graph."""
        params = (weight, gamma, beta, mean, var)
        if x.ndim != 5 or x.shape[1] != 1:
            raise ValueError(f"x must be (B, 1, D, H, W), got "
                             f"{tuple(x.shape)}")
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
        pdtype = weight.dtype
        if weight.shape != WEIGHT_SHAPE or pdtype not in DTYPE_CODES or any(
                t.shape != (CHANNELS,) or t.dtype != pdtype
                for t in params[1:]):
            raise ValueError(
                f"weight {WEIGHT_SHAPE} and gamma, beta, mean and var "
                f"({CHANNELS},) must be of one dtype in {list(DTYPE_CODES)}, "
                f"got " + ", ".join(f"{t.dtype} {tuple(t.shape)}"
                                    for t in params))
        if not x.is_contiguous():
            raise ValueError(f"{self.name} takes x contiguous (strides "
                             f"{x.stride()})")
        check_layout(self.name, params, ())
        dev = check_device(self.name, (x, *params), "; the block has no "
                           "backward kernel: train mode runs ConvBnAct")
        B, _, D, H, W = x.shape
        out = torch.empty((B, D, H, W, CHANNELS), dtype=x.dtype,
                          device=x.device).permute(0, 4, 1, 2, 3)
        if out.numel():
            eps_bits, = struct.unpack("=i", struct.pack("=f", eps))
            self._launch(dev, x.data_ptr(), *(t.data_ptr() for t in params),
                         out.data_ptr(), B, D, H, W, DTYPE_CODES[x.dtype],
                         DTYPE_CODES[pdtype], eps_bits)
        return out


in_conv_cuda = InConvKernel(LIBRARY, "in_conv_cuda", "in_conv_fwd")
