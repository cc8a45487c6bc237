"""TransMVSNet trained (``configs/transmvsnet_train.json``): the model of
``architectures/transmvsnet.py`` (its reference, drawn weights and port
model, re-exported), trained with its focal loss by the traffic kind
``traffic/focal_steps.py`` against ``reference/train_focal.py``.

The count of a training step (``flops(train=True)``): every convolution
three times (forward, input gradient, weight gradient), the images'
first convolution twice (its input takes no gradient), as
``counts/flops.py::net_flops`` counts a training step; the ARF's
deformable contractions (2 x 9 C^2 a pixel) and the FMT's operations
(``transmvsnet.py::fmt_flops``) three times; K1 and K2 by
``cost_volume_flops(..., backward=True)``. The launch checks of a step:
K1 and K2 once a level, the deformable conv's forward and backward kernels
once a conv.
"""
from __future__ import annotations

from perfbench.architectures import transmvsnet
from perfbench.architectures.casmvsnet import (COST_REG_INPUTS,
                                               FEATURE_INPUTS, IMAGE_CONV)
from perfbench.architectures.transmvsnet import (drawn, fmt_flops,
                                                 port_model, reference)
from perfbench.counts.flops import _one_conv, cost_volume_flops, net_flops
from perfbench.reference.transmvsnet import TransMVSNet

__all__ = ["reference", "drawn", "port_model", "flops", "launch_checks"]


def flops(config: dict, img_wh, n_views: int, batch: int,
          train: bool = False) -> int:
    """Operations of one training step (``train``), else of one forward
    (``transmvsnet.py``'s count), at ``batch`` scenes of ``n_views``
    images of ``img_wh``."""
    if not train:
        return transmvsnet.flops(config, img_wh, n_views, batch)
    model = TransMVSNet(config)
    W, H = img_wh
    N = batch * n_views
    total = net_flops(model.feature, FEATURE_INPUTS, N, (H, W), True,
                      (IMAGE_CONV,))
    for l, arf in enumerate(model.arf):
        h, w = H >> l, W >> l
        C = config["feature_channels"][l]
        for i in range(config["arf"]["convs_per_level"]):
            dcn = getattr(arf, f"dcn{i}")
            total += 3 * _one_conv(dcn.conv_offset_mask, N, (h, w))
            total += 3 * 2 * N * h * w * 9 * C * C
    fmt = config["fmt"]
    total += 3 * fmt_flops(n_views, batch, (H >> 2) * (W >> 2),
                           fmt["d_model"], fmt["heads"], fmt["blocks"])
    for name, stride in (("dim_reduction_1", 4), ("smooth_1", 2),
                         ("dim_reduction_2", 2), ("smooth_2", 1)):
        total += 3 * _one_conv(getattr(model, name), N, (H // stride,
                                                         W // stride))
    for l in range(model.levels):
        total += net_flops(getattr(model, f"cost_reg_{l}"), COST_REG_INPUTS,
                           batch, (model.n_depths[l], H >> l, W >> l), True)
    return total + cost_volume_flops(
        config["n_depths"], config["feature_channels"], img_wh, n_views,
        batch, config["cost_volume"], backward=True)


def launch_checks(config: dict, train: bool) -> dict[str, tuple[str, int]]:
    """A training step's K1 and K2 once a level and the deformable conv's
    forward and backward kernels once a conv (no plain fallback); a
    forward's are ``transmvsnet.py``'s."""
    if not train:
        return transmvsnet.launch_checks(config, False)
    convs = config["levels"] * config["arf"]["convs_per_level"]
    return {"k1_launch_gap": ("cost_volume_cuda", config["levels"]),
            "k2_launch_gap": ("cost_volume_bwd_cuda", config["levels"]),
            "dcn_launch_gap": ("deform_conv_cuda", convs),
            "dcn_bwd_launch_gap": ("deform_conv_bwd_cuda", convs)}
