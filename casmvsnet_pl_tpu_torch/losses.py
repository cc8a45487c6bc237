"""Training objectives, each model's own (``CascadeMVSNet.objective``).

- :func:`sl1_loss`, CasMVSNet's, the counterpart of
  ``casmvsnet_pl_tpu/losses.py``: multi-scale masked SmoothL1 (beta 1) over
  the cascade levels, level l weighted 2^(1-l) (2, 1, 0.5 fine to coarse),
  each level's loss the mean over its masked pixels.
- :func:`focal_loss`, TransMVSNet's (Ding et al., arXiv:2111.14600): per
  level the focal loss of the probability volume at the hypothesis nearest
  the ground truth, for winner-take-all depth has no gradient.

Both are computed in float32 whatever the prediction's dtype.

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


FOCAL_GAMMA = 2.0
FOCAL_WEIGHTS = (1.0, 1.0, 1.0)     # lambda_l, fine to coarse
LOG_EPS = 1e-6


def focal_loss(results: dict[str, Tensor], depths: dict[str, Tensor],
               masks: dict[str, Tensor], levels: int = 3,
               distributed: bool = False) -> Tensor:
    """TransMVSNet's focal loss: sum over levels of lambda_l
    (``FOCAL_WEIGHTS``) times the mean, over the level's masked pixels p
    (over every rank's batch with ``distributed``, see
    :func:`masked_mean`), of

        -(1 - P_l(p, d~))^gamma log(P_l(p, d~) + 1e-6),   gamma = 2,

    d~ the level's hypothesis nearest the ground truth (the first of a
    tie), P_l its probability. A ground truth outside the level's window
    still counts, at the nearest end of the window.

    results: {'prob_l': (B, D, h, w), 'depth_values_l': (B, D, h, w)};
    depths, masks: {'level_l': (B, h, w)}.
    """
    loss = None
    for l in range(levels):
        prob = results[f"prob_{l}"].float()
        hyp = results[f"depth_values_{l}"].float()
        gt = depths[f"level_{l}"].float()
        nearest = (hyp - gt[:, None]).abs().argmin(dim=1, keepdim=True)
        p = torch.gather(prob, 1, nearest)[:, 0]
        focal = -(1.0 - p) ** FOCAL_GAMMA * torch.log(p + LOG_EPS)
        term = masked_mean(focal, masks[f"level_{l}"], distributed) * \
            FOCAL_WEIGHTS[l]
        loss = term if loss is None else loss + term
    return loss


loss_dict = {"sl1": sl1_loss}
