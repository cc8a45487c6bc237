"""Training objectives.

Counterpart of ``casmvsnet_pl_tpu/losses.py``: multi-scale masked SmoothL1
(beta 1) over the cascade levels, level l weighted 2^(1-l) (2, 1, 0.5 fine
to coarse), each level's loss the mean over its masked pixels. Computed in
float32 whatever the prediction's dtype.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def smooth_l1(pred: Tensor, target: Tensor) -> Tensor:
    """Elementwise SmoothL1 (Huber, beta 1): 0.5 d^2 if |d| < 1 else |d| - 0.5."""
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(values: Tensor, mask: Tensor) -> Tensor:
    """Mean of ``values`` over the True pixels of ``mask`` (0 if it is empty)."""
    mask_f = mask.float()
    total = torch.sum(values * mask_f)
    count = torch.sum(mask_f)
    return torch.where(count > 0, total / count.clamp(min=1.0),
                       torch.zeros_like(total))


def sl1_loss(results: dict[str, Tensor], depths: dict[str, Tensor],
             masks: dict[str, Tensor], levels: int = 3) -> Tensor:
    """Multi-scale masked SmoothL1.

    results: {'depth_l': (B, h, w)}; depths, masks: {'level_l': (B, h, w)}.
    """
    loss = None
    for l in range(levels):
        lvl = smooth_l1(results[f"depth_{l}"], depths[f"level_{l}"])
        term = masked_mean(lvl, masks[f"level_{l}"]) * (2.0 ** (1 - l))
        loss = term if loss is None else loss + term
    return loss


loss_dict = {"sl1": sl1_loss}
