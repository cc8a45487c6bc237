"""Floating-point operations of convolutions and cost volumes, and the
card's published peaks.

A frozen copy of the port's ``utils/flops.py`` arithmetic (its analytic
convolution count, which equals ``torch.utils.flop_counter``'s, and its
cost-volume count), read off a reference model's layers, so that a later
change to the port cannot move the yardstick; each architecture
(``architectures/<arch>.py``) sums its own layers with it:

  - a convolution counts 2 operations a multiply-add and no bias:
    2 x batch x (output positions) x taps x Cout x Cin; a transposed
    convolution counts its input positions;
  - the cost volume counts its float32 operations per (b, d, pixel): per
    source view 29 for the projection and tap weights and 8C for the taps,
    then the combine of the configuration's ``cost_volume`` (variance
    3CS + 4C, groupwise correlation 2CS + C); the backward adds 8CS for
    the scatter;
  - a training step counts each convolution three times (forward, input
    gradient, weight gradient), one whose input takes no gradient twice.
"""
from __future__ import annotations

import math

import torch.nn as nn

# NVIDIA's data sheet, dense rates without sparsity, H100 SXM5 at 700 W
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
F32_FLOPS = 67e12               # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)


def _one_conv(m: nn.Module, batch: int, in_size) -> int:
    k = m.kernel_size
    if isinstance(m, nn.ConvTranspose3d):
        positions = in_size
    else:
        positions = [(n + 2 * p - d * (kk - 1) - 1) // s + 1 for n, p, d, kk, s
                     in zip(in_size, m.padding, m.dilation, k, m.stride)]
    w = m.weight.shape
    return 2 * batch * math.prod(positions) * math.prod(k) * w[0] * w[1]


def net_flops(net: nn.Module, inputs: dict[str, int], batch: int, size,
              train: bool, no_input_grad=()) -> int:
    """The convolutions of ``net`` at ``batch`` inputs of ``size``, each
    convolution's input at ``size`` over its stride in ``inputs`` (by
    module name; a convolution missing from the table raises);
    ``no_input_grad`` names those whose input takes no gradient."""
    total = 0
    for name, m in net.named_modules():
        if isinstance(m, CONVS):
            n = _one_conv(m, batch, [s // inputs[name] for s in size])
            times = 1 if not train else (2 if name in no_input_grad else 3)
            total += n * times
    return total


def combine_ops(S: int, C: int, cost_volume: str) -> int:
    return {"variance": 3 * C * S + 4 * C,
            "groupwise": 2 * C * S + C}[cost_volume]


def sample_ops(S: int, C: int, cost_volume: str) -> int:
    return S * (29 + 8 * C) + combine_ops(S, C, cost_volume)


def cost_volume_flops(n_depths, channels, img_wh, n_views: int, batch: int,
                      cost_volume: str, backward: bool = False) -> int:
    """float32 operations of the cascade's cost volumes (fine to coarse)."""
    W, H = img_wh
    S = n_views - 1
    total = 0
    for l, (D, C) in enumerate(zip(n_depths, channels)):
        per = sample_ops(S, C, cost_volume) + (8 * C * S if backward else 0)
        total += batch * D * (H >> l) * (W >> l) * per
    return total


def peak_bf16(card: str) -> float | None:
    """The card's published dense bf16 rate, or None for a card not in the
    table (the share is then not reported)."""
    return PEAK_BF16.get(card)
