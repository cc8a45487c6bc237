"""Launch the modulated deformable 3x3 convolution of TransMVSNet's ARF,
``csrc/deform_conv.cu``.

One wrapper with its own launch count, ``deform_conv_cuda``, over the
shared library that ``kernels/cost_volume.py`` builds from ``csrc/``. It
replaces no TPU kernel (the JAX package has no TransMVSNet). Plain version:
``ops/deform_conv.py::plain_deform_conv``. The wrapper is a raw launch that
records no autograd graph; ``ops/deform_conv.py::deform_conv`` calls it on
CUDA tensors. There is no fallback: on a CUDA tensor the wrapper launches
its kernel or raises.
"""
from __future__ import annotations

import torch

from .cost_volume import _DTYPE_CODES, _LIBRARY, _Kernel, check_device, \
    check_layout

Tensor = torch.Tensor

CHANNELS = (8, 16, 32)
OFFSET_MASK = 27            # 2 x 9 offsets and 9 masks a pixel


class DeformConvKernel(_Kernel):
    """The deformable conv's forward, ``csrc/deform_conv.cu``."""

    def __call__(self, x: Tensor, offset_mask: Tensor,
                 weight: Tensor) -> Tensor:
        """x (N, C, H, W) f32|bf16 in channels_last, C in {8, 16, 32},
        16-byte aligned; offset_mask (N, 27, H, W) of x's dtype in
        channels_last, the raw output of the offset-and-mask conv; weight
        (C, C, 3, 3) of x's dtype, contiguous. Returns (N, C, H, W) in x's
        dtype, channels_last, with no autograd graph."""
        dev = check_device(self.name, (x, offset_mask, weight),
                           "; the deformable conv has no backward yet")
        if x.ndim != 4 or x.shape[1] not in CHANNELS:
            raise ValueError(f"x must be (N, C, H, W) with C in {CHANNELS}, "
                             f"got {tuple(x.shape)}")
        N, C, H, W = x.shape
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"x dtype {x.dtype} not in {list(_DTYPE_CODES)}")
        if offset_mask.shape != (N, OFFSET_MASK, H, W) \
                or offset_mask.dtype != x.dtype:
            raise ValueError(f"offset_mask must be {x.dtype} "
                             f"{(N, OFFSET_MASK, H, W)}, got "
                             f"{offset_mask.dtype} "
                             f"{tuple(offset_mask.shape)}")
        if weight.shape != (C, C, 3, 3) or weight.dtype != x.dtype:
            raise ValueError(f"weight must be {x.dtype} {(C, C, 3, 3)}, got "
                             f"{weight.dtype} {tuple(weight.shape)}")
        for t, what in ((x, "x"), (offset_mask, "offset_mask")):
            if not t.is_contiguous(memory_format=torch.channels_last):
                raise ValueError(f"{self.name} takes {what} in channels_last "
                                 f"(strides {t.stride()})")
        out = torch.empty((N, H, W, C), dtype=x.dtype,
                          device=x.device).permute(0, 3, 1, 2)
        check_layout(self.name, (weight,), (x, out), "x")
        if out.numel():
            self._launch(dev, x.data_ptr(), offset_mask.data_ptr(),
                         weight.data_ptr(), out.data_ptr(), N, H, W, C,
                         _DTYPE_CODES[x.dtype])
        return out


deform_conv_cuda = DeformConvKernel(_LIBRARY, "deform_conv_cuda",
                                    "deform_conv_fwd")
