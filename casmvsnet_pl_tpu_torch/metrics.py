"""Depth-map metrics.

Counterpart of ``casmvsnet_pl_tpu/metrics.py``: masked absolute error and
acc@threshold (the fraction of masked pixels with |error| < t), as masked
means for train logging and as (sum, count) pairs so validation sums over
batches and divides once. :func:`batch_means` gives the train logs'
means over the global batch of a data-parallel step.
"""
from __future__ import annotations

import torch

from .parallel import all_reduce_dict

Tensor = torch.Tensor


def abs_error(depth_pred: Tensor, depth_gt: Tensor, mask: Tensor) -> Tensor:
    """Per-pixel |pred - gt|, zero outside the mask."""
    err = (depth_pred.float() - depth_gt.float()).abs()
    return torch.where(mask, err, torch.zeros_like(err))


def abs_error_mean(depth_pred: Tensor, depth_gt: Tensor,
                   mask: Tensor) -> Tensor:
    count = mask.float().sum().clamp(min=1.0)
    return abs_error(depth_pred, depth_gt, mask).sum() / count


def acc_threshold_mean(depth_pred: Tensor, depth_gt: Tensor, mask: Tensor,
                       threshold: float) -> Tensor:
    """Fraction of masked pixels with error < threshold."""
    hit = mask & (abs_error(depth_pred, depth_gt, mask) < threshold)
    return hit.float().sum() / mask.float().sum().clamp(min=1.0)


def metric_sums(depth_pred: Tensor, depth_gt: Tensor, mask: Tensor,
                thresholds=(1.0, 2.0, 4.0)) -> dict[str, Tensor]:
    """Pixel-weighted sums for validation: {'abs_err_sum', 'acc_<t>mm_sum'
    ..., 'mask_sum'}; divide by mask_sum after summing over batches."""
    err = abs_error(depth_pred, depth_gt, mask)
    out = {"abs_err_sum": err.sum(), "mask_sum": mask.float().sum()}
    for t in thresholds:
        out[f"acc_{int(t)}mm_sum"] = (mask & (err < t)).float().sum()
    return out


def batch_means(depth_pred: Tensor, depth_gt: Tensor, mask: Tensor,
                distributed: bool = False) -> dict[str, Tensor]:
    """{'abs_err', 'acc_1mm', 'acc_2mm', 'acc_4mm'}: the masked means of
    :func:`abs_error_mean` and :func:`acc_threshold_mean`, over every
    rank's pixels with ``distributed`` (one all-reduce of the sums)."""
    sums = metric_sums(depth_pred, depth_gt, mask)
    if distributed:
        sums = all_reduce_dict(sums)
    count = sums.pop("mask_sum").clamp(min=1.0)
    return {k[:-len("_sum")]: v / count for k, v in sums.items()}
