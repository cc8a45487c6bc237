"""The least time of the ARF's deformable-conv kernel (``csrc/
deform_conv.cu``, ``deform_conv_kernel`` and ``deform_conv_kernel_mma``) a
map: each modulated deformable 3x3 conv, C -> C, over N images of h x w.

Bytes, each read or written once: the input (C a pixel), the offsets and
masks (27 a pixel), the weights (9 C^2) and the output (C a pixel), at
``itemsize`` bytes a value (bf16: 2). Operations, a pixel: the sampling's
9 C bilinear samples, each 4 multiply-adds and the mask's product (81 C),
on the CUDA cores at the 67 TFLOP/s float32 rate; and the contraction's
9 C^2 multiply-adds (18 C^2), which in bf16 at C >= 16 run on the tensor
cores (``mma.sync``), counted once at the card's dense bf16 rate, and
otherwise on the CUDA cores with the sampling. The least time is the
largest of the bytes over 3.35 TB/s and each unit's operations over its
rate.
"""
from __future__ import annotations

from .flops import F32_FLOPS, HBM_BYTES_PER_S, PEAK_BF16

OFFSET_MASK = 27
MMA_CHANNELS = 16       # the least C whose bf16 contraction uses mma.sync
TENSOR_FLOPS = PEAK_BF16["NVIDIA H100 80GB HBM3"]


def dcn_work(N: int, h: int, w: int, C: int, itemsize: int = 2
             ) -> tuple[int, int, int]:
    """(bytes, CUDA-core float32 operations, tensor-core operations) of
    one deformable conv."""
    n = N * h * w
    nbytes = (n * C + n * OFFSET_MASK + 9 * C * C + n * C) * itemsize
    sampling, contraction = n * 81 * C, n * 18 * C * C
    if itemsize == 2 and C >= MMA_CHANNELS:
        return nbytes, sampling, contraction
    return nbytes, sampling + contraction, 0


def dcn_bound_s(N: int, h: int, w: int, C: int, itemsize: int = 2
                ) -> tuple[float, str]:
    """The least time of one deformable conv, seconds, and what sets it
    (``bytes``, ``operations`` or ``tensor operations``)."""
    nbytes, ops, tensor_ops = dcn_work(N, h, w, C, itemsize)
    return max((nbytes / HBM_BYTES_PER_S, "bytes"),
               (ops / F32_FLOPS, "operations"),
               (tensor_ops / TENSOR_FLOPS, "tensor operations"))


def arf_bound_s(config: dict, img_wh, n_views: int, batch: int,
                itemsize: int = 2) -> float:
    """The least time of every deformable conv of a map (the ARF's convs a
    level, at each level's size and channels), seconds."""
    W, H = img_wh
    return sum(config["arf"]["convs_per_level"] * dcn_bound_s(
        batch * n_views, H >> l, W >> l, C, itemsize)[0]
        for l, C in enumerate(config["feature_channels"]))
