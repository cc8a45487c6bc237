"""TransMVSNet (Ding et al., arXiv:2111.14600; megvii-research/TransMVSNet):
CasMVSNet's trunk, ARF's modulated deformable convs on each of its outputs,
the Feature Matching Transformer on the 1/4 level, a top-down pathway, and
the cascade on the one-channel correlation volume with winner-take-all
depth (``reference/transmvsnet.py``). Eval only: the port does not train
it.

The seed draws, in module order:
  - every convolution weight and every deformable conv's weight,
    Kaiming-normal (deviation sqrt(2 / fan_in), fan_in the input channels
    times the taps), as ``casmvsnet.py`` draws them;
  - every Linear weight of the FMT, normal with deviation sqrt(1 / fan_in);
  - each ``conv_offset_mask`` weight, normal with deviation
    sqrt(1 / fan_in) = 1 / sqrt(9 C): at unit-scale input (independent
    normal channels) its outputs, the offsets in pixels, have an RMS of
    about 1 (0.96-1.01 measured over the nine convs at 64x64, 3 seeds,
    CPU), and the masks sigmoid(N(0, 1)) spread over (0.1, 0.9). On the
    benchmark's scenes (128x96, 3 views, 3 seeds, CPU) the offsets read an
    RMS of 0.27-5.5 px by conv, as the trunk's and the ARF's outputs are
    not at unit scale. Zero offsets would make the ARF a plain conv.
BatchNorm and LayerNorm stay the identity and every bias is zero, so that
nothing of the weights comes from the process's global generator.

The count (``flops``): the trunk's convolutions as CasMVSNet's; the ARF's
offset-and-mask convs and deformable contractions, each counted as a 3x3
convolution (C -> 27, C -> C); the FMT's projections, MLP and attention
products (per layer call over n query and s source tokens: q and merge
2 n d^2 each, k and v 2 s d^2 each, the MLP 2 n (4 d^2 + 2 d^2), K^T V and
Q (K^T V) 2 s d d_h and 2 n d d_h, the normalizer 2 n d; a cross layer's
k and v over the reference's tokens once a scene); the pathway's four
convolutions; the CostRegNets at one input channel; and
``cost_volume_flops`` of the groupwise correlation with one group.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.architectures.casmvsnet import (COST_REG_INPUTS,
                                               FEATURE_INPUTS)
from perfbench.counts.flops import CONVS, _one_conv, cost_volume_flops, \
    net_flops
from perfbench.reference.transmvsnet import DeformConv, QLinear, TransMVSNet


def reference(config: dict) -> nn.Module:
    """The plain float32 reference, its biases zero."""
    model = TransMVSNet(config)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, CONVS + (QLinear,)) and m.bias is not None:
                m.bias.zero_()
    return model


def drawn(model: nn.Module) -> list[tuple[str, float]]:
    """Every convolution, deformable conv and Linear weight, in module
    order (see the module's docstring for the deviations)."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, CONVS):
            w = m.weight
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose3d) \
                else w.shape[1]
            fan_in = cin * math.prod(m.kernel_size)
            gain = 1.0 if name.endswith("conv_offset_mask") else 2.0
            out.append((f"{name}.weight", math.sqrt(gain / fan_in)))
        elif isinstance(m, DeformConv):
            fan_in = math.prod(m.weight.shape[1:])
            out.append((f"{name}.weight", math.sqrt(2.0 / fan_in)))
        elif isinstance(m, QLinear):
            out.append((f"{name}.weight", math.sqrt(1.0 / m.in_features)))
    return out


def port_model(config: dict, weights: dict, device, dtype=None):
    """The port's ``TransMVSNet`` of ``config`` with ``weights``, on
    ``device`` (its parameters in ``dtype`` if given)."""
    from casmvsnet_pl_tpu_torch.models import TransMVSNet as Port
    fmt = config["fmt"]
    model = Port(n_depths=tuple(config["n_depths"]),
                 interval_ratios=tuple(config["interval_ratios"]),
                 d_model=fmt["d_model"], nhead=fmt["heads"],
                 blocks=fmt["blocks"], sampling="auto")
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    return model.to(dtype=dtype)


def fmt_flops(n_views: int, batch: int, tokens: int, d: int, heads: int,
              blocks: int) -> int:
    """The FMT's operations: ``blocks`` self layers over every view's
    ``tokens`` and cross layers from the reference into each source
    view."""
    dh = d // heads

    def layer(n: int, s: int) -> int:
        return (2 * n * d * d * 2 + 2 * s * d * d * 2 + 2 * n * 6 * d * d
                + 2 * s * d * dh + 2 * n * d * dh + 2 * n * d)
    views = batch * n_views * tokens
    sources = batch * (n_views - 1) * tokens
    return blocks * (layer(views, views) + layer(sources, batch * tokens))


def flops(config: dict, img_wh, n_views: int, batch: int,
          train: bool = False) -> int:
    """Operations of one forward at ``batch`` scenes of ``n_views`` images
    of ``img_wh`` (see the module's docstring)."""
    if train:
        raise ValueError("TransMVSNet has no training step in the port")
    model = TransMVSNet(config)
    W, H = img_wh
    N = batch * n_views
    total = net_flops(model.feature, FEATURE_INPUTS, N, (H, W), False)
    for l, arf in enumerate(model.arf):
        h, w = H >> l, W >> l
        C = config["feature_channels"][l]
        for i in range(config["arf"]["convs_per_level"]):
            dcn = getattr(arf, f"dcn{i}")
            total += _one_conv(dcn.conv_offset_mask, N, (h, w))
            total += 2 * N * h * w * 9 * C * C
    fmt = config["fmt"]
    total += fmt_flops(n_views, batch, (H >> 2) * (W >> 2), fmt["d_model"],
                       fmt["heads"], fmt["blocks"])
    for name, stride in (("dim_reduction_1", 4), ("smooth_1", 2),
                         ("dim_reduction_2", 2), ("smooth_2", 1)):
        total += _one_conv(getattr(model, name), N, (H // stride,
                                                     W // stride))
    for l in range(model.levels):
        total += net_flops(getattr(model, f"cost_reg_{l}"), COST_REG_INPUTS,
                           batch, (model.n_depths[l], H >> l, W >> l), False)
    return total + cost_volume_flops(
        config["n_depths"], config["feature_channels"], img_wh, n_views,
        batch, config["cost_volume"])


def launch_checks(config: dict, train: bool) -> dict[str, tuple[str, int]]:
    """K1 once a level a map and the deformable conv's kernel three times a
    level: no fallback to a plain version."""
    if train:
        raise ValueError("TransMVSNet has no training step in the port")
    return {"k1_launch_gap": ("cost_volume_cuda", config["levels"]),
            "dcn_launch_gap": ("deform_conv_cuda", config["levels"] *
                               config["arf"]["convs_per_level"])}
