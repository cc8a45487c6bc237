"""The least time of the cost-volume kernels K1 and K2: a frozen copy of
the port's ``probes/common.py::cv_work`` and ``bound``, with the combine
read from the configuration's ``cost_volume``, not from G = 1.

Bytes: features, projections and depths read once, the volume (K1) or its
gradient (K2) read or written once (C channels of a variance, G of a
groupwise correlation), and K2's float32 feature gradient written once.
Operations: per sample and source view 29 for the projection and tap
weights and 8C for the taps, then the combine; the backward's own work is
those samples once more and 8C a view for the scatter. The least time is
the larger of the bytes over 3.35 TB/s and the operations over the
67 TFLOP/s float32 rate.
"""
from __future__ import annotations

from .flops import F32_FLOPS, HBM_BYTES_PER_S, sample_ops


def cv_work(B, V, D, h, w, C, cost_volume, groups, itemsize,
            backward=False):
    """(bytes, float32 operations) of K1, or of K2 with ``backward``, at
    one level."""
    S, n = V - 1, B * D * h * w
    out_channels = {"variance": C, "groupwise": groups}[cost_volume]
    nbytes = (B * V * h * w * C * itemsize + B * S * 12 * 4 + n * 4
              + n * out_channels * itemsize)
    per = sample_ops(S, C, cost_volume)
    if not backward:
        return nbytes, n * per
    return nbytes + B * V * h * w * C * 4, n * (per + 8 * C * S)


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def cascade_bound_s(config: dict, img_wh, n_views: int, batch: int,
                    itemsize: int = 2, backward: bool = False) -> float:
    """The least time of K1 (or K2) over the cascade's levels, seconds."""
    W, H = img_wh
    total = 0.0
    for l, (D, C) in enumerate(zip(config["n_depths"],
                                   config["feature_channels"])):
        total += bound_s(*cv_work(batch, n_views, D, H >> l, W >> l, C,
                                  config["cost_volume"], config["num_groups"],
                                  itemsize, backward))
    return total
