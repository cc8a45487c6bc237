"""The least time of the ARF's deformable-conv backward kernel (``csrc/
deform_conv_bwd.cu``, ``deform_conv_bwd_kernel``) a training step: each
modulated deformable 3x3 conv's gradients, C -> C, over N images of h x w.

Bytes, each read or written once: the input, the incoming gradient (C a
pixel each) and the offsets and masks (27), read at ``itemsize`` bytes a
value (bf16: 2); the offsets' and masks' gradient (27) written at
``itemsize``; the input's gradient, summed in float32 (C a pixel, 4 bytes);
the weights and their float32 gradient (9 C^2 each). Operations, a pixel:
the two contractions, the samples' gradient W^T gy and the weight's
gradient gy (m s)^T (9 C^2 multiply-adds each, 36 C^2), priced as
``counts/deform_conv.py`` prices the forward's: on bf16 operands at
C >= 16 once at the card's dense bf16 tensor-core rate, otherwise at the
67 TFLOP/s float32 rate of the CUDA cores; and per tap sample 4 taps of C
values, each a multiply-add into the sample and one into the tap's dot
product with the gradient (144 C), on the CUDA cores. The float32 adds of
the scatter (36 C a pixel) are the L2's atomics, which no published rate
prices; they are not counted. The least time is the largest of the bytes
over 3.35 TB/s and each unit's operations over its rate.
"""
from __future__ import annotations

from .deform_conv import MMA_CHANNELS, OFFSET_MASK, TENSOR_FLOPS
from .flops import F32_FLOPS, HBM_BYTES_PER_S


def dcn_bwd_work(N: int, h: int, w: int, C: int, itemsize: int = 2
                 ) -> tuple[int, int, int]:
    """(bytes, CUDA-core float32 operations, tensor-core operations) of one
    deformable conv's backward."""
    n = N * h * w
    nbytes = (n * (2 * C + 2 * OFFSET_MASK) * itemsize + n * C * 4
              + 9 * C * C * (itemsize + 4))
    sampling, contractions = n * 144 * C, n * 36 * C * C
    if itemsize == 2 and C >= MMA_CHANNELS:
        return nbytes, sampling, contractions
    return nbytes, sampling + contractions, 0


def dcn_bwd_bound_s(N: int, h: int, w: int, C: int, itemsize: int = 2
                    ) -> tuple[float, str]:
    """The least time of one deformable conv's backward, seconds, and what
    sets it (``bytes``, ``operations`` or ``tensor operations``)."""
    nbytes, ops, tensor_ops = dcn_bwd_work(N, h, w, C, itemsize)
    return max((nbytes / HBM_BYTES_PER_S, "bytes"),
               (ops / F32_FLOPS, "operations"),
               (tensor_ops / TENSOR_FLOPS, "tensor operations"))


def arf_bwd_bound_s(config: dict, img_wh, n_views: int, batch: int,
                    itemsize: int = 2) -> float:
    """The least time of every deformable conv's backward of a step (the
    ARF's convs a level, at each level's size and channels), seconds."""
    W, H = img_wh
    return sum(config["arf"]["convs_per_level"] * dcn_bwd_bound_s(
        batch * n_views, H >> l, W >> l, C, itemsize)[0]
        for l, C in enumerate(config["feature_channels"]))
