"""CascadeMVSNet: coarse-to-fine cascaded plane-sweep depth inference.

Counterpart of ``casmvsnet_pl_tpu/models/cascade.py::CascadeMVSNet``: shared
FPN features for all views; per level a plane-sweep cost volume (variance or
groupwise correlation), a 3D U-Net, a softmax over depth, soft-argmax depth
and a 4-bin confidence. Level 2 sweeps uniformly from ``init_depth_min``;
levels 1 and 0 recentre a narrower window on the x2-upsampled previous depth
(gradient-stopped). The per-level lists ``n_depths`` and ``interval_ratios``
are indexed fine -> coarse. ``sampling`` picks each level's cost-volume
route (``ops/plane_sweep.py::build_cost_volume``): "auto" (the fused K1/K2
kernels), "quad" (packed-quad rows and the cost epilogue kernels) or
"window" (the window mode's clamped samples where C <= 8, level 0 of the
default model; K1/K2 elsewhere), as the JAX model's ``sampling`` field.

Precision: the features, cost volumes and convolutions run in the compute
dtype: the parameters' dtype for inference (``entry.py`` casts the model
to bf16 on the card), or ``torch.autocast``'s in training, where the
parameters and BatchNorm statistics stay float32 (``engine/trainer.py``).
Projections, softmax, depth regression and confidence run in float32.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.nn as nn

from ..losses import sl1_loss
from ..ops.geometry import (depth_regression, get_depth_values,
                            initial_depth_values, resize_bilinear)
from ..ops.plane_sweep import build_cost_volume
from ..utils.profiling import span
from .cost_reg import CostRegNet
from .feature_net import FeatureNet

Tensor = torch.Tensor
FEATURE_CHANNELS = (8, 16, 32)          # FeatureNet output C per level


def _sum4_confidence(prob: Tensor, depth_values_len: int) -> Tensor:
    """Probability mass of the 4 bins from index-1 to index+2 around the
    soft-argmax index (truncated like ``.long()``, clipped to [0, D-1]),
    without gradient. prob: (B, D, H, W) -> (B, H, W)."""
    D = depth_values_len
    prob = prob.detach().float()
    padded = nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    cs = nn.functional.pad(torch.cumsum(padded, dim=1), (0, 0, 0, 0, 1, 0))
    sum4 = cs[:, 4:D + 4] - cs[:, :D]                        # (B, D, H, W)
    steps = torch.arange(D, dtype=torch.float32, device=prob.device)
    idx_f = torch.sum(prob * steps[None, :, None, None], dim=1)
    idx = idx_f.long().clamp(0, D - 1)
    return torch.gather(sum4, 1, idx[:, None])[:, 0]


def _on_device(value, dev: torch.device, site: str) -> Tensor:
    """``value`` (a scalar or (B,)) as float32 on ``dev``. A value not
    already there is copied from the host, which blocks the host until the
    card's queue drains: a ``host_sync`` span."""
    if isinstance(value, Tensor) and value.device == dev:
        return value.to(torch.float32)
    with span("host_sync", site=site):
        return torch.as_tensor(value, dtype=torch.float32, device=dev)


class CascadeMVSNet(nn.Module):
    def __init__(self, n_depths: Sequence[int] = (8, 32, 48),
                 interval_ratios: Sequence[float] = (1.0, 2.0, 4.0),
                 num_groups: int = 1, sampling: str = "auto"):
        super().__init__()
        levels = len(FEATURE_CHANNELS)
        if len(n_depths) != levels or len(interval_ratios) != levels:
            raise ValueError(f"n_depths and interval_ratios need one entry "
                             f"per level ({levels})")
        if any(d % 8 for d in n_depths):
            raise ValueError(f"n_depths must be divisible by 8 (got "
                             f"{tuple(n_depths)}): the cost regularizer "
                             "halves the depth axis three times")
        self.n_depths = tuple(int(d) for d in n_depths)
        self.interval_ratios = tuple(float(r) for r in interval_ratios)
        self.num_groups = num_groups
        self.sampling = sampling
        self.levels = levels
        self.feature = FeatureNet()
        for l in range(levels):
            cin = FEATURE_CHANNELS[l] if num_groups == 1 else num_groups
            self.add_module(f"cost_reg_{l}", CostRegNet(cin))

    def features(self, imgs: Tensor) -> dict[str, Tensor]:
        """imgs: (B, V, H, W, 3) -> {'level_l': (B, V, h_l, w_l, C_l)}."""
        B, V, H, W, _ = imgs.shape
        dtype = self.feature.toplayer.weight.dtype
        feats = self.feature(imgs.reshape(B * V, H, W, 3).to(dtype))
        return {k: f.reshape(B, V, *f.shape[1:]) for k, f in feats.items()}

    def from_features(self, feats: dict[str, Tensor], proj_mats: Tensor,
                      init_depth_min, depth_interval,
                      cost_volume: Callable | None = None,
                      volumes: bool = False) -> dict[str, Tensor]:
        """The cascade after feature extraction.

        proj_mats: (B, V-1, levels, 3, 4) f32; init_depth_min and
        depth_interval: scalars or (B,). ``cost_volume(feats, proj_mats,
        depth_values, groups)`` builds each level's volume; None means
        :func:`build_cost_volume` with the model's ``sampling``. A caller
        passes another only to compare it with a plain version. With
        ``volumes`` the results also hold each level's probability volume
        ``prob_l`` (B, D, h, w) f32 and its hypotheses ``depth_values_l``.
        """
        if cost_volume is None:
            cost_volume = self.default_cost_volume()
        B = proj_mats.shape[0]
        dev = proj_mats.device
        dmin = _on_device(init_depth_min, dev, "from_features.init_depth_min")
        dint = _on_device(depth_interval, dev, "from_features.depth_interval")
        dmin, dint = dmin.expand(B), dint.expand(B)
        results: dict[str, Tensor] = {}
        depth_prev = None
        for l in reversed(range(self.levels)):               # 2, 1, 0
            with span("cascade.level", level=l):
                feats_l = feats[f"level_{l}"]                # (B, V, h, w, C)
                h, w = feats_l.shape[2:4]
                interval_l = dint * self.interval_ratios[l]
                D = self.n_depths[l]
                with span("cascade.hypotheses"):
                    if depth_prev is None:
                        depth_values = initial_depth_values(
                            dmin, interval_l, D, B, h, w, device=dev)
                    else:
                        prev = resize_bilinear(depth_prev.detach()[..., None],
                                               (h, w))[..., 0]
                        depth_values = get_depth_values(prev, D, interval_l)
                with span("cascade.cost_volume"):
                    volume = cost_volume(feats_l,
                                         proj_mats[:, :, l].contiguous(),
                                         depth_values, self.num_groups)
                with span("cascade.cost_reg"):
                    cost = getattr(self, f"cost_reg_{l}")(volume)
                with span("cascade.regression"):
                    prob = torch.softmax(cost.float(), dim=1)  # (B, D, h, w)
                    depth_l, conf_l = self.depth_and_confidence(prob,
                                                                depth_values)
                    results[f"depth_{l}"] = depth_l
                    results[f"confidence_{l}"] = conf_l
                    if volumes:
                        results[f"prob_{l}"] = prob
                        results[f"depth_values_{l}"] = depth_values
                depth_prev = depth_l
        return results

    def default_cost_volume(self) -> Callable:
        """Each level's volume: :func:`build_cost_volume` with the model's
        ``sampling`` (the variance at one group, else the groupwise
        correlation)."""
        return functools.partial(build_cost_volume, sampling=self.sampling)

    def depth_and_confidence(self, prob: Tensor, depth_values: Tensor
                             ) -> tuple[Tensor, Tensor]:
        """A level's depth and confidence from its probability volume
        (B, D, h, w), float32: the soft-argmax over the hypotheses and the
        4-bin mass around it."""
        return (depth_regression(prob, depth_values),
                _sum4_confidence(prob, depth_values.shape[1]))

    def objective(self, results: dict[str, Tensor], depths: dict[str, Tensor],
                  masks: dict[str, Tensor], levels: int = 3,
                  distributed: bool = False) -> Tensor:
        """The training loss of the forward's ``results``: multi-scale masked
        SmoothL1 on the depths (``losses.py::sl1_loss``)."""
        return sl1_loss(results, depths, masks, levels, distributed)

    def forward(self, imgs: Tensor, proj_mats: Tensor, init_depth_min,
                depth_interval, cost_volume: Callable | None = None,
                volumes: bool = False) -> dict[str, Tensor]:
        """imgs: (B, V, H, W, 3) normalized images; proj_mats:
        (B, V-1, levels, 3, 4), level index fine -> coarse.
        Returns {'depth_l': (B, h_l, w_l), 'confidence_l': ...}, l = 0, 1, 2,
        and with ``volumes`` each level's 'prob_l' and 'depth_values_l'
        (:meth:`from_features`).
        """
        with span("cascade.features"):
            feats = self.features(imgs)
        return self.from_features(feats, proj_mats, init_depth_min,
                                  depth_interval, cost_volume, volumes)
