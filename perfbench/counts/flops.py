"""The model's floating-point operations, and the card's published peaks.

A frozen copy of the port's ``utils/flops.py`` arithmetic (its analytic
convolution count, which equals ``torch.utils.flop_counter``'s, and its
cost-volume count), read off the reference model's layers, so that a later
change to the port cannot move the yardstick:

  - a convolution counts 2 operations a multiply-add and no bias:
    2 x batch x (output positions) x taps x Cout x Cin; a transposed
    convolution counts its input positions;
  - the cost volume counts its float32 operations per (b, d, pixel): per
    source view 29 for the projection and tap weights and 8C for the taps,
    then the combine (variance 3CS + 4C, groupwise 2CS + C); the backward
    adds 8CS for the scatter;
  - a training step counts each convolution three times (forward, input
    gradient, weight gradient) except the images' convolution, whose input
    takes no gradient, twice.
"""
from __future__ import annotations

import math

import torch.nn as nn

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

# NVIDIA's data sheet, dense rates without sparsity, H100 SXM5 at 700 W
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
F32_FLOPS = 67e12               # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)


def _one_conv(m: nn.Module, batch: int, in_size) -> int:
    k = m.kernel_size
    if isinstance(m, nn.ConvTranspose3d):
        positions = in_size
    else:
        positions = [(n + 2 * p - d * (kk - 1) - 1) // s + 1 for n, p, d, kk, s
                     in zip(in_size, m.padding, m.dilation, k, m.stride)]
    w = m.weight.shape
    return 2 * batch * math.prod(positions) * math.prod(k) * w[0] * w[1]


def _net(net: nn.Module, inputs: dict, batch: int, size, train: bool) -> int:
    total = 0
    for name, m in net.named_modules():
        if isinstance(m, _CONVS):
            n = _one_conv(m, batch, [s // inputs[name] for s in size])
            times = 1 if not train else (2 if name == IMAGE_CONV and
                                         inputs is FEATURE_INPUTS else 3)
            total += n * times
    return total


def conv_flops(model: nn.Module, img_wh, n_views: int, batch: int,
               train: bool = False) -> int:
    """The convolutions of one forward (``train``: forward and backward) of
    a reference ``CascadeMVSNet`` at ``batch`` scenes of ``n_views`` images
    of ``img_wh``."""
    W, H = img_wh
    total = _net(model.feature, FEATURE_INPUTS, batch * n_views, (H, W),
                 train)
    for l in range(model.levels):
        total += _net(getattr(model, f"cost_reg_{l}"), COST_REG_INPUTS,
                      batch, (model.n_depths[l], H >> l, W >> l), train)
    return total


def combine_ops(S: int, C: int, groups: int) -> int:
    return 3 * C * S + 4 * C if groups == 1 else 2 * C * S + C


def sample_ops(S: int, C: int, groups: int) -> int:
    return S * (29 + 8 * C) + combine_ops(S, C, groups)


def cost_volume_flops(n_depths, channels, img_wh, n_views: int, batch: int,
                      groups: int = 1, backward: bool = False) -> int:
    """float32 operations of the cascade's cost volumes (fine to coarse)."""
    W, H = img_wh
    S = n_views - 1
    total = 0
    for l, (D, C) in enumerate(zip(n_depths, channels)):
        per = sample_ops(S, C, groups) + (8 * C * S if backward else 0)
        total += batch * D * (H >> l) * (W >> l) * per
    return total


def model_flops(model: nn.Module, config: dict, img_wh, n_views: int,
                batch: int, train: bool = False) -> int:
    """Convolutions plus cost volumes of one forward (``train``: one
    training step) at ``batch`` scenes."""
    return conv_flops(model, img_wh, n_views, batch, train) + \
        cost_volume_flops(config["n_depths"], config["feature_channels"],
                          img_wh, n_views, batch, config["num_groups"],
                          backward=train)


def peak_bf16(card: str) -> float | None:
    """The card's published dense bf16 rate, or None for a card not in the
    table (the share is then not reported)."""
    return PEAK_BF16.get(card)
