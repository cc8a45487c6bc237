"""Launch the modulated deformable 3x3 convolution of TransMVSNet's ARF:
its forward, ``csrc/deform_conv.cu``, and its backward,
``csrc/deform_conv_bwd.cu``.

Two wrappers, each with its own launch count, over the shared library that
``kernels/library.py`` builds from ``csrc/``: ``deform_conv_cuda`` (the
forward) and ``deform_conv_bwd_cuda`` (the gradients of the input, the
offsets and masks, and the weight; its ``spill_counts()`` reads how much
of the input's gradient the binned scatter spilled to global atomics).
They replace no TPU kernel (the JAX package has no TransMVSNet). Plain
version: ``ops/deform_conv.py::plain_deform_conv`` and its autograd. The
wrappers are raw launches that record no autograd graph; ``ops/
deform_conv.py::deform_conv`` joins them into a ``torch.autograd.Function``
on CUDA tensors. There is no fallback: on a CUDA tensor a wrapper launches
its kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .library import (DTYPE_CODES, LIBRARY, Kernel, check_device,
                      check_layout)

Tensor = torch.Tensor

CHANNELS = (8, 16, 32)
OFFSET_MASK = 27            # 2 x 9 offsets and 9 masks a pixel


class DeformConvKernel(Kernel):
    """The deformable conv's forward, ``csrc/deform_conv.cu``."""

    def __call__(self, x: Tensor, offset_mask: Tensor,
                 weight: Tensor) -> Tensor:
        """x (N, C, H, W) f32|bf16 in channels_last, C in {8, 16, 32},
        16-byte aligned; offset_mask (N, 27, H, W) of x's dtype in
        channels_last, the raw output of the offset-and-mask conv; weight
        (C, C, 3, 3) of x's dtype, contiguous. Returns (N, C, H, W) in x's
        dtype, channels_last, with no autograd graph."""
        dev = _check_inputs(self.name, x, offset_mask, weight)
        N, C, H, W = x.shape
        out = _nhwc(x)
        check_layout(self.name, (weight,), (x, out), "x")
        if out.numel():
            self._launch(dev, x.data_ptr(), offset_mask.data_ptr(),
                         weight.data_ptr(), out.data_ptr(), N, H, W, C,
                         DTYPE_CODES[x.dtype])
        return out


class SpillCounts(NamedTuple):
    """What ``deform_conv_bwd_cuda``'s launches did with the input
    gradient's shares (a share: one tap of one sample inside the image, C
    floats)."""
    spilled: int        # shares sent to global float4 atomics one by one
    shares: int         # every share
    window_floats: int  # floats of the windows' sums added to d_x


class DeformConvBwdKernel(Kernel):
    """The deformable conv's backward, ``csrc/deform_conv_bwd.cu``, with its
    own launch count and, on each device, a buffer of three counters that
    every launch adds to (:meth:`spill_counts`)."""

    def __init__(self, *args):
        super().__init__(*args)
        self._counts: dict[int, Tensor] = {}

    def __call__(self, x: Tensor, offset_mask: Tensor, weight: Tensor,
                 grad_out: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Inputs as :meth:`DeformConvKernel.__call__`, plus grad_out, the
        gradient of its output: (N, C, H, W) of x's dtype in channels_last.
        Returns the gradients of x and of offset_mask (channels_last) and of
        weight, each in its tensor's dtype: x's and the weight's summed in
        float32 (atomics, in an order that changes from run to run) and
        rounded once, offset_mask's formed in float32 and rounded once."""
        dev = _check_inputs(self.name, x, offset_mask, weight, grad_out)
        N, C, H, W = x.shape
        if grad_out.shape != x.shape or grad_out.dtype != x.dtype or \
                not grad_out.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"grad_out must be {x.dtype} {tuple(x.shape)} "
                             f"in channels_last, got {grad_out.dtype} "
                             f"{tuple(grad_out.shape)} (strides "
                             f"{grad_out.stride()})")
        d_x = _nhwc(x, torch.float32, zero=True)
        d_om = _nhwc(offset_mask)
        d_w = torch.zeros_like(weight, dtype=torch.float32)
        check_layout(self.name, (weight, d_w), (x, grad_out, d_x), "x")
        if d_x.numel():
            counts = self._counts.get(dev)
            if counts is None:
                counts = self._counts[dev] = torch.zeros(
                    len(SpillCounts._fields), dtype=torch.int64,
                    device=x.device)
            self._launch(dev, x.data_ptr(), offset_mask.data_ptr(),
                         weight.data_ptr(), grad_out.data_ptr(),
                         d_x.data_ptr(), d_om.data_ptr(), d_w.data_ptr(),
                         counts.data_ptr(), N, H, W, C, DTYPE_CODES[x.dtype])
        return d_x.to(x.dtype), d_om, d_w.to(weight.dtype)

    def spill_counts(self) -> SpillCounts:
        """The counters summed over every device and every launch since the
        last :meth:`reset_spill_counts`. Reading waits for the device; the
        launches never do."""
        sums = [0] * len(SpillCounts._fields)
        for counts in self._counts.values():
            sums = [a + b for a, b in zip(sums, counts.tolist())]
        return SpillCounts(*sums)

    def reset_spill_counts(self) -> None:
        for counts in self._counts.values():
            counts.zero_()


def _nhwc(like: Tensor, dtype=None, zero: bool = False) -> Tensor:
    """A new (N, C, H, W) tensor of ``like``'s shape in channels_last."""
    N, C, H, W = like.shape
    make = torch.zeros if zero else torch.empty
    return make((N, H, W, C), dtype=dtype or like.dtype,
                device=like.device).permute(0, 3, 1, 2)


def _check_inputs(name: str, x: Tensor, offset_mask: Tensor, weight: Tensor,
                  *extra: Tensor) -> int:
    """Raise on anything the kernels do not take (see
    :meth:`DeformConvKernel.__call__`); returns the device index."""
    dev = check_device(name, (x, offset_mask, weight, *extra),
                       "; differentiate through ops.deform_conv.deform_conv")
    if x.ndim != 4 or x.shape[1] not in CHANNELS:
        raise ValueError(f"x must be (N, C, H, W) with C in {CHANNELS}, "
                         f"got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if offset_mask.shape != (N, OFFSET_MASK, H, W) \
            or offset_mask.dtype != x.dtype:
        raise ValueError(f"offset_mask must be {x.dtype} "
                         f"{(N, OFFSET_MASK, H, W)}, got "
                         f"{offset_mask.dtype} {tuple(offset_mask.shape)}")
    if weight.shape != (C, C, 3, 3) or weight.dtype != x.dtype:
        raise ValueError(f"weight must be {x.dtype} {(C, C, 3, 3)}, got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    for t, what in ((x, "x"), (offset_mask, "offset_mask")):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} takes {what} in channels_last "
                             f"(strides {t.stride()})")
    return dev


deform_conv_cuda = DeformConvKernel(LIBRARY, "deform_conv_cuda",
                                    "deform_conv_fwd")
deform_conv_bwd_cuda = DeformConvBwdKernel(LIBRARY, "deform_conv_bwd_cuda",
                                           "deform_conv_bwd")
