"""The least time of CostRegNet's input block at one input channel
(``csrc/in_conv.cu``, ``in_conv_kernel``) a map: the 3x3x3 conv 1 -> 8
with eval BatchNorm and leaky ReLU 0.01 in one pass, once a level on the
cost volume of a configuration whose volume has one channel (the groupwise
correlation of one group: TransMVSNet's).

Bytes, each read or written once: the volume (1 value a voxel) and the
activation (8 values a voxel) at ``itemsize`` bytes a value (bf16: 2), 18
bytes a voxel. Operations: the conv's 27 x 8 multiply-adds a voxel (432),
priced on the unit the kernel runs them on: in bf16 the tensor cores
(``mma.sync``) at the card's dense bf16 rate, in float32 the CUDA cores at
67 TFLOP/s. BatchNorm and the activation (a few operations a value) are
not counted. A level's least time is the larger of its bytes over
3.35 TB/s and its operations over their unit's rate.
"""
from __future__ import annotations

from .flops import F32_FLOPS, HBM_BYTES_PER_S, PEAK_BF16

TENSOR_FLOPS = PEAK_BF16["NVIDIA H100 80GB HBM3"]
OUT_CHANNELS = 8
TAPS = 27


def in_conv_work(B: int, D: int, h: int, w: int, itemsize: int = 2
                 ) -> tuple[int, int]:
    """(bytes, operations) of one launch over a (B, D, h, w) volume."""
    n = B * D * h * w
    return n * (1 + OUT_CHANNELS) * itemsize, 2 * TAPS * OUT_CHANNELS * n


def in_conv_bound_s(B: int, D: int, h: int, w: int, itemsize: int = 2
                    ) -> tuple[float, str]:
    """The least time of one launch, seconds, and what sets it (``bytes``
    or ``operations``)."""
    nbytes, ops = in_conv_work(B, D, h, w, itemsize)
    rate = TENSOR_FLOPS if itemsize == 2 else F32_FLOPS
    return max((nbytes / HBM_BYTES_PER_S, "bytes"), (ops / rate,
                                                     "operations"))


def one_channel(config: dict) -> bool:
    """Whether the configuration's cost volume has one channel."""
    return config["cost_volume"] == "groupwise" and config["num_groups"] == 1


def map_bound_s(config: dict, img_wh, batch: int, itemsize: int = 2
                ) -> float:
    """The least time of a map's launches (one a level, level l at 1 / 2^l
    of ``img_wh`` with ``n_depths[l]`` depths), seconds."""
    W, H = img_wh
    return sum(in_conv_bound_s(batch, D, H >> l, W >> l, itemsize)[0]
               for l, D in enumerate(config["n_depths"]))
