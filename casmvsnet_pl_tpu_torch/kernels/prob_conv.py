"""Launch CostRegNet's 8 -> 1 ``prob`` convolution, ``csrc/prob_conv.cu``.

One wrapper with its own launch count, ``prob_conv_cuda``, over the shared
library that ``kernels/cost_volume.py`` builds from ``csrc/``. It replaces
no TPU kernel: it takes the 3x3x3 convolution of 8 channels to 1 from
cuDNN, whose generic kernel for one output channel leaves the tensor cores
idle. Plain version: ``F.conv3d``. The wrapper is a raw launch that records
no autograd graph; ``ops/prob_conv.py::prob_conv`` joins it and cuDNN's
backward into a ``torch.autograd.Function``. There is no fallback: on a
CUDA tensor the wrapper launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .cost_volume import _DTYPE_CODES, _LIBRARY, _Kernel, check_device, \
    check_layout

Tensor = torch.Tensor

CHANNELS = 8
WEIGHT_SHAPE = (1, CHANNELS, 3, 3, 3)


class ProbConvKernel(_Kernel):
    """The ``prob`` conv's forward, ``csrc/prob_conv.cu``."""

    def __call__(self, x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
        """x (B, 8, D, H, W) f32|bf16 in channels_last_3d, 16-byte
        aligned; weight (1, 8, 3, 3, 3) and bias (1,) of one dtype, f32 or
        bf16. Returns (B, D, H, W) in x's dtype, padding 1 on D, H and W,
        with no autograd graph."""
        dev = check_device(self.name, (x, weight, bias), "; differentiate "
                           "through ops.prob_conv.prob_conv")
        if x.ndim != 5 or x.shape[1] != CHANNELS:
            raise ValueError(f"x must be (B, {CHANNELS}, D, H, W), got "
                             f"{tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"x dtype {x.dtype} not in {list(_DTYPE_CODES)}")
        if weight.shape != WEIGHT_SHAPE or bias.shape != (1,) \
                or weight.dtype != bias.dtype \
                or weight.dtype not in _DTYPE_CODES:
            raise ValueError(f"weight and bias must be {WEIGHT_SHAPE} and "
                             f"(1,) of one dtype in {list(_DTYPE_CODES)}, got "
                             f"{weight.dtype} {tuple(weight.shape)} and "
                             f"{bias.dtype} {tuple(bias.shape)}")
        if not x.is_contiguous(memory_format=torch.channels_last_3d):
            raise ValueError(f"{self.name} takes x in channels_last_3d "
                             f"(strides {x.stride()})")
        check_layout(self.name, (weight, bias), (x,), "x")
        B, _, D, H, W = x.shape
        out = x.new_empty((B, D, H, W))
        if out.numel():
            self._launch(dev, x.data_ptr(), weight.data_ptr(),
                         bias.data_ptr(), out.data_ptr(), B, D, H, W,
                         _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype])
        return out


prob_conv_cuda = ProbConvKernel(_LIBRARY, "prob_conv_cuda", "prob_conv_fwd")
