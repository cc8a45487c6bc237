"""Training objectives.

Counterpart of ``casmvsnet_pl_tpu/losses.py``: multi-scale masked SmoothL1
(beta 1) over the cascade levels, level l weighted 2^(1-l) (2, 1, 0.5 fine
to coarse), each level's loss the mean over its masked pixels. Computed in
float32 whatever the prediction's dtype.

In a data-parallel step the mean is over the global batch, as the JAX
trainer takes it over its sharded batch: each rank divides its own masked
sum by the mask count of every rank (all-reduced, no gradient through it)
and scales by the number of ranks N, so that the gradients that
``DistributedDataParallel`` averages are those of the global loss. The
value a rank returns is then not the global loss: that is the mean of the
ranks' values.
"""
from __future__ import annotations

import torch

from .parallel import all_reduce_sum, world_size

Tensor = torch.Tensor


def smooth_l1(pred: Tensor, target: Tensor) -> Tensor:
    """Elementwise SmoothL1 (Huber, beta 1): 0.5 d^2 if |d| < 1 else |d| - 0.5."""
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(values: Tensor, mask: Tensor,
                distributed: bool = False) -> Tensor:
    """Mean of ``values`` over the True pixels of ``mask`` (0 if it is
    empty); with ``distributed``, this rank's share of the mean over every
    rank's pixels, times the number of ranks."""
    mask_f = mask.float()
    total = torch.sum(values * mask_f)
    count = torch.sum(mask_f)
    if distributed:
        count = all_reduce_sum(count.detach())
        total = total * world_size()
    return torch.where(count > 0, total / count.clamp(min=1.0),
                       torch.zeros_like(total))


def sl1_loss(results: dict[str, Tensor], depths: dict[str, Tensor],
             masks: dict[str, Tensor], levels: int = 3,
             distributed: bool = False) -> Tensor:
    """Multi-scale masked SmoothL1 (over every rank's batch with
    ``distributed``, see :func:`masked_mean`).

    results: {'depth_l': (B, h, w)}; depths, masks: {'level_l': (B, h, w)}.
    """
    loss = None
    for l in range(levels):
        lvl = smooth_l1(results[f"depth_{l}"], depths[f"level_{l}"])
        term = masked_mean(lvl, masks[f"level_{l}"], distributed) * \
            (2.0 ** (1 - l))
        loss = term if loss is None else loss + term
    return loss


loss_dict = {"sl1": sl1_loss}
