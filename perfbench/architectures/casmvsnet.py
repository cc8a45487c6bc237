"""CasMVSNet (Gu et al., arXiv:1912.06378; kwea123/CasMVSNet_pl): FeatureNet,
then per level a plane-sweep cost volume (variance, or the groupwise
correlation of Xu and Tao) and a CostRegNet, coarse to fine.

The seed draws every convolution weight, Kaiming-normal (deviation
sqrt(2 / fan_in), fan_in the input channels times the taps), as trained
networks keep their activations at unit scale. BatchNorm stays the
identity (weight 1, bias 0, running mean 0, variance 1), and the biases of
the convolutions that have one (FeatureNet's laterals and smoothing,
CostRegNet's ``prob``) zero, so that nothing of the weights comes from the
process's global generator.

The count (``counts/flops.py``, a frozen copy of the port's
``utils/flops.py``) reads the convolutions off the reference's layers,
each at the stride of its input from the tables below, and adds the cost
volumes; in a training step the images' convolution, whose input takes no
gradient, counts twice and every other three times.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.counts.flops import CONVS, cost_volume_flops, net_flops
from perfbench.reference.model import CascadeMVSNet

FEATURE_INPUTS = {
    "conv0.0.conv": 1, "conv0.1.conv": 1, "conv1.0.conv": 1,
    "conv1.1.conv": 2, "conv1.2.conv": 2, "conv2.0.conv": 2,
    "conv2.1.conv": 4, "conv2.2.conv": 4, "toplayer": 4, "lat1": 2,
    "lat0": 1, "smooth1": 2, "smooth0": 1}
COST_REG_INPUTS = {
    "conv0.conv": 1, "conv1.conv": 1, "conv2.conv": 2, "conv3.conv": 2,
    "conv4.conv": 4, "conv5.conv": 4, "conv6.conv": 8, "conv7.0": 8,
    "conv9.0": 4, "conv11.0": 2, "prob": 1}
IMAGE_CONV = "conv0.0.conv"       # FeatureNet's first: no input gradient


def reference(config: dict) -> nn.Module:
    """The plain float32 reference (``reference/model.py``), its
    convolutions' biases zero."""
    model = CascadeMVSNet(config)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, CONVS) and m.bias is not None:
                m.bias.zero_()
    return model


def drawn(model: nn.Module) -> list[tuple[str, float]]:
    """Every convolution weight, in module order, Kaiming-normal."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, CONVS):
            w = m.weight
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose3d) \
                else w.shape[1]
            fan_in = cin * math.prod(m.kernel_size)
            out.append((f"{name}.weight", math.sqrt(2.0 / fan_in)))
    return out


def port_model(config: dict, weights: dict, device, dtype=None):
    """The port's ``CascadeMVSNet`` of ``config`` with ``weights``, on
    ``device`` (its parameters in ``dtype`` if given)."""
    from casmvsnet_pl_tpu_torch.models import CascadeMVSNet as Port
    model = Port(n_depths=tuple(config["n_depths"]),
                 interval_ratios=tuple(config["interval_ratios"]),
                 num_groups=config["num_groups"], sampling="auto")
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    return model.to(dtype=dtype)


def flops(config: dict, img_wh, n_views: int, batch: int,
          train: bool = False) -> int:
    """Convolutions plus cost volumes of one forward (``train``: one
    training step) at ``batch`` scenes of ``n_views`` images of
    ``img_wh``."""
    model = CascadeMVSNet(config)
    W, H = img_wh
    no_grad = (IMAGE_CONV,)
    total = net_flops(model.feature, FEATURE_INPUTS, batch * n_views, (H, W),
                      train, no_grad)
    for l in range(model.levels):
        total += net_flops(getattr(model, f"cost_reg_{l}"), COST_REG_INPUTS,
                           batch, (model.n_depths[l], H >> l, W >> l), train)
    return total + cost_volume_flops(
        config["n_depths"], config["feature_channels"], img_wh, n_views,
        batch, config["cost_volume"], backward=train)


def launch_checks(config: dict, train: bool) -> dict[str, tuple[str, int]]:
    """K1 once a level a map or step and, in training, K2 once a level a
    step: no fallback to the plain cost volume."""
    checks = {"k1_launch_gap": ("cost_volume_cuda", config["levels"])}
    if train:
        checks["k2_launch_gap"] = ("cost_volume_bwd_cuda", config["levels"])
    return checks
