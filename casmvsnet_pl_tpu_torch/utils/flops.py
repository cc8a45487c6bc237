"""Floating-point operations of the cascade, and the card's published peak.

The count of the model's own work, what any implementation of CasMVSNet
must do, so that a share of peak compares implementations:

  - :func:`conv_flops`: ``torch.utils.flop_counter.FlopCounterMode`` over
    one forward, the convolutions by the model's top modules (``feature``,
    ``cost_reg_2``, ``cost_reg_1``, ``cost_reg_0``);
  - :func:`analytic_conv_flops`: the same count from the layer shapes
    alone, with no forward run;
  - :func:`prob_conv_flops`: the ``prob`` convs' forward, which the
    counter cannot see on the card (a kernel of the port,
    ``csrc/prob_conv.cu``), from their shapes;
  - :func:`cost_volume_flops`: the cost volume's float32 operations, which
    the counter cannot see (K1 and K2 are extension calls, and the plain
    version's gathers and sums carry no FLOP formula);
  - :func:`forward_flops`: convolutions plus cost volume;
  - :func:`peak_flops`: the card's published dense rate by name.

A convolution counts 2 operations a multiply-add and no bias, torch's
convention: 2 x batch x (output positions) x taps x Cout x Cin/groups; a
transposed convolution counts its *input* positions, 2 x batch x (input
positions) x taps x Cin x Cout/groups, as each input value meets the
whole kernel. The JAX package's ``scripts/flops_report.py`` counts with
XLA's ``cost_analysis()``, which includes the work its folded and
tap-unrolled regularizers do by design: at 64x96x3, B=1, XLA counts 8.605
GFLOP for the JAX forward where this module counts 1.838 GFLOP of
convolutions; the JAX ``FeatureNet``'s convolutions alone agree to the
operation.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..models.cascade import FEATURE_CHANNELS

# The input of each convolution, as the divisor of its net's input size
# (the image for FeatureNet; the level's (D, h, w) for CostRegNet), by the
# name of the module under the net: the topology of the nets' forwards.
FEATURE_INPUTS = {
    "conv0.0.conv": 1, "conv0.1.conv": 1, "conv1.0.conv": 1,
    "conv1.1.conv": 2, "conv1.2.conv": 2, "conv2.0.conv": 2,
    "conv2.1.conv": 4, "conv2.2.conv": 4, "toplayer": 4, "lat1": 2,
    "lat0": 1, "smooth1": 2, "smooth0": 1}
COST_REG_INPUTS = {
    "conv0.conv": 1, "conv1.conv": 1, "conv2.conv": 2, "conv3.conv": 2,
    "conv4.conv": 4, "conv5.conv": 4, "conv6.conv": 8, "conv7.0": 8,
    "conv9.0": 4, "conv11.0": 2, "prob": 1}

# NVIDIA's data sheet, dense rates without sparsity, by the name torch and
# nvidia-smi give the card: the H100 SXM5 at its 700 W limit.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {torch.bfloat16: 989e12,
                                        torch.float32: 67e12}}

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)


def _conv_ops(counts: dict) -> int:
    """The convolutions' share of one module's FlopCounterMode counts."""
    return sum(n for op, n in counts.items() if "convolution" in str(op))


def counted_conv_flops(module: nn.Module, fn, *args) -> dict[str, int]:
    """Convolution FLOPs that ``FlopCounterMode`` counts while ``fn(*args)``
    runs (forward, and backward where ``fn`` runs one), by the name of each
    top module of ``module`` that runs a convolution."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    counts = counter.get_flop_counts()
    root = type(module).__name__
    out = {}
    for name, _ in module.named_children():
        n = _conv_ops(counts.get(f"{root}.{name}", {}))
        if n:
            out[name] = n
    total = _conv_ops(counts.get("Global", {}))
    if sum(out.values()) != total:
        raise AssertionError(f"convolutions outside the top modules: "
                             f"{total} against {out}")
    return out


def conv_flops(model: nn.Module, *inputs) -> dict[str, int]:
    """FlopCounterMode's count of the convolutions of one forward
    ``model(*inputs)`` (under ``torch.inference_mode``), by top module."""
    def forward():
        with torch.inference_mode():
            model(*inputs)
    return counted_conv_flops(model, forward)


def _one_conv(m: nn.Module, batch: int, in_size) -> int:
    """One convolution at ``batch`` inputs of spatial size ``in_size``,
    torch's convention (module docstring)."""
    k = m.kernel_size
    if isinstance(m, nn.ConvTranspose3d):
        positions = in_size
    else:
        positions = [(n + 2 * p - d * (kk - 1) - 1) // s + 1 for n, p, d, kk, s
                     in zip(in_size, m.padding, m.dilation, k, m.stride)]
    w = m.weight.shape
    return 2 * batch * math.prod(positions) * math.prod(k) * w[0] * w[1]


def _net_flops(net: nn.Module, inputs: dict, batch: int, size) -> int:
    total = 0
    for name, m in net.named_modules():
        if isinstance(m, _CONVS):
            if name not in inputs:
                raise ValueError(f"no input size known for convolution "
                                 f"{name!r} of {type(net).__name__}")
            total += _one_conv(m, batch, [n // inputs[name] for n in size])
    return total


def analytic_conv_flops(model: nn.Module, img_wh, n_views: int,
                        batch: int) -> dict[str, int]:
    """The convolutions of one forward of a ``CascadeMVSNet`` at ``batch``
    scenes of ``n_views`` images of ``img_wh``, from its layer shapes and
    ``FEATURE_INPUTS`` / ``COST_REG_INPUTS``: FeatureNet over B·V images of
    H x W, ``cost_reg_l`` over B volumes of (D_l, H/2^l, W/2^l). Equal to
    :func:`conv_flops` of that forward."""
    W, H = img_wh
    out = {"feature": _net_flops(model.feature, FEATURE_INPUTS,
                                 batch * n_views, (H, W))}
    for l in reversed(range(model.levels)):
        out[f"cost_reg_{l}"] = _net_flops(
            getattr(model, f"cost_reg_{l}"), COST_REG_INPUTS, batch,
            (model.n_depths[l], H >> l, W >> l))
    return out


def prob_conv_flops(model: nn.Module, img_wh, batch: int) -> dict[str, int]:
    """The forward of each level's ``prob`` conv, by top module, from its
    shape: the share of :func:`analytic_conv_flops` that a count on the
    card adds to :func:`conv_flops` and :func:`counted_conv_flops`, whose
    counter does not see the kernel that runs it there (its backward, on
    cuDNN, it sees)."""
    W, H = img_wh
    return {f"cost_reg_{l}": _one_conv(
        getattr(model, f"cost_reg_{l}").prob, batch,
        (model.n_depths[l], H >> l, W >> l)) for l in range(model.levels)}


def combine_ops(S: int, C: int, groups: int) -> int:
    """float32 operations of the variance or groupwise combine per (b, d,
    pixel): per view 3C (variance: s, o^2, sq) or 2C (groupwise), then 4C
    (variance) or C (groupwise) to finish."""
    return 3 * C * S + 4 * C if groups == 1 else 2 * C * S + C


def sample_ops(S: int, C: int, groups: int) -> int:
    """float32 operations of the cost volume per (b, d, pixel) with S
    source views of C channels: per source view 29 for the projection and
    the tap weights and 8C for the 4 bilinear taps, then the combine."""
    return S * (29 + 8 * C) + combine_ops(S, C, groups)


def cost_volume_flops(n_depths, channels, img_wh, n_views: int, batch: int,
                      groups: int = 1, backward: bool = False) -> int:
    """float32 operations of the cascade's cost volumes, the arithmetic K1
    does: sum over levels l of B·D_l·(H/2^l)·(W/2^l) samples times
    :func:`sample_ops` (S = V-1, C = C_l), that is per sample
    S·(29 + 8·C) + 3·C·S + 4·C for variance (groups 1) and
    S·(29 + 8·C) + 2·C·S + C for groupwise. ``backward`` adds the
    backward's own work, the 8·C·S operations of the scatter (K2).
    ``n_depths`` and ``channels`` run fine to coarse, as the model's."""
    W, H = img_wh
    S = n_views - 1
    total = 0
    for l, (D, C) in enumerate(zip(n_depths, channels)):
        per = sample_ops(S, C, groups) + (8 * C * S if backward else 0)
        total += batch * D * (H >> l) * (W >> l) * per
    return total


def forward_flops(model: nn.Module, img_wh, n_views: int, batch: int
                  ) -> dict[str, int]:
    """One forward of a ``CascadeMVSNet``: ``conv`` (analytic), ``cost_volume``
    and their sum ``total``."""
    conv = sum(analytic_conv_flops(model, img_wh, n_views, batch).values())
    cv = cost_volume_flops(model.n_depths, FEATURE_CHANNELS, img_wh, n_views,
                           batch, model.num_groups)
    return {"conv": conv, "cost_volume": cv, "total": conv + cv}


def peak_flops(device, dtype: torch.dtype = torch.bfloat16) -> float:
    """The published dense peak in FLOP/s of ``device`` (a CUDA device, or
    the card's name as torch gives it) for ``dtype``. A card missing from
    ``PEAK_FLOPS``, and the CPU, raise rather than guess."""
    try:
        device = torch.device(device)
    except RuntimeError:            # not a device: the card's name
        name = device
    else:
        if device.type != "cuda":
            raise ValueError(f"no published peak for {device}")
        name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS or dtype not in PEAK_FLOPS[name]:
        raise ValueError(f"no published {dtype} peak for {name!r}: add the "
                         "card's data-sheet rate to PEAK_FLOPS")
    return PEAK_FLOPS[name][dtype]
