"""CasMVSNet in plain PyTorch: the reference that decides ``correct``.

Written from the published description (CasMVSNet; the groupwise cost
volume of Xu and Tao) and the module and state-dict names of the reference
repository (kwea123/CasMVSNet_pl ``models/``), in float32 and the NCHW
layout, with no kernel, no fused path and nothing of the port:

  - FeatureNet: three strided stages (8/16/32 channels at 1, 1/2, 1/4),
    a top-down pathway (1x1 laterals, x2 bilinear upsampling with aligned
    corners) and 3x3 smoothing to 16 and 8 channels;
  - per level, a plane-sweep cost volume over the level's depth hypotheses:
    the variance over all V views (the reference view unwarped), or the
    groupwise correlation (the mean over each group of channels of
    warped * ref, averaged over the V-1 source views); bilinear samples
    with zeros for each tap outside the image;
  - CostRegNet, a 3D U-Net (3x3x3 convs, BatchNorm, leaky ReLU 0.01,
    transposed convs up) to one cost per depth; softmax over depth,
    soft-argmax depth, and the probability mass of the 4 bins around the
    soft-argmax index as confidence;
  - levels coarse to fine: level 2 sweeps uniformly from the minimum depth;
    levels 1 and 0 centre a window of D_l hypotheses, interval
    ``depth_interval * ratio_l``, on the x2-upsampled coarser depth,
    without gradient through it.

Departures from the published code, each shared with the system under
test: BatchNorm's train mode normalizes with the biased batch variance
(the running statistics do not enter any number compared); a sample whose
projected depth is behind the source camera (n_z <= 1e-7 d) reads zeros.

``quant`` rounds what a lower-precision implementation would hold at each
convolution (input, weight, output) and at the cost volume's input and
output, forward and backward: None is float32; "bf16" rounds to bfloat16;
"fp8" to float8 e4m3 with one scale a tensor (its largest magnitude at
448), as scaled fp8 training does. The convolutions and sums themselves run
in float32 with TF32 off (:func:`float32_exact`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor
LEAKY = 0.01
BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN inside the block; the process's
    settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_to(x: Tensor, quant: str | None) -> Tensor:
    """x rounded to ``quant`` and back to float32 (no gradient)."""
    if quant is None:
        return x
    if quant == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if quant == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"unknown quant {quant!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return round_to(x, quant)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.quant), None


def q(x: Tensor, quant: str | None) -> Tensor:
    return x if quant is None else _Round.apply(x, quant)


class QConv2d(nn.Conv2d):
    """A convolution whose input, weight and output are rounded to
    ``quant`` (None: float32)."""
    quant = None

    def forward(self, x):
        y = F.conv2d(q(x, self.quant), q(self.weight, self.quant), self.bias,
                     self.stride, self.padding)
        return q(y, self.quant)


class QConv3d(nn.Conv3d):
    quant = None

    def forward(self, x):
        y = F.conv3d(q(x, self.quant), q(self.weight, self.quant), self.bias,
                     self.stride, self.padding)
        return q(y, self.quant)


class QConvTranspose3d(nn.ConvTranspose3d):
    quant = None

    def forward(self, x):
        y = F.conv_transpose3d(q(x, self.quant), q(self.weight, self.quant),
                               self.bias, self.stride, self.padding,
                               self.output_padding)
        return q(y, self.quant)


QCONVS = (QConv2d, QConv3d, QConvTranspose3d)


class BN(nn.Module):
    """BatchNorm: batch statistics (biased variance) in train mode, running
    statistics in eval mode. Parameters and buffers by the reference's
    names."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            mean = x.mean(dims)
            var = ((x - mean.view(shape)) ** 2).mean(dims)
        else:
            mean, var = self.running_mean, self.running_var
        xhat = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
        return xhat * self.weight.view(shape) + self.bias.view(shape)


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, dims=2, k=3, s=1, p=1):
        super().__init__()
        cls = QConv2d if dims == 2 else QConv3d
        self.conv = cls(cin, cout, k, stride=s, padding=p, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), LEAKY)


class DeconvBnAct(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(QConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                          output_padding=1, bias=False),
                         BN(cout))

    def forward(self, x):
        return F.leaky_relu(super().forward(x), LEAKY)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnAct(3, 8), ConvBnAct(8, 8))
        self.conv1 = nn.Sequential(ConvBnAct(8, 16, k=5, s=2, p=2),
                                   ConvBnAct(16, 16), ConvBnAct(16, 16))
        self.conv2 = nn.Sequential(ConvBnAct(16, 32, k=5, s=2, p=2),
                                   ConvBnAct(32, 32), ConvBnAct(32, 32))
        self.toplayer = QConv2d(32, 32, 1)
        self.lat1 = QConv2d(16, 32, 1)
        self.lat0 = QConv2d(8, 32, 1)
        self.smooth1 = QConv2d(32, 16, 3, padding=1)
        self.smooth0 = QConv2d(32, 8, 3, padding=1)

    def forward(self, x):
        """x (N, 3, H, W) -> [level 0 (N, 8, H, W), 1 (16, H/2), 2 (32, H/4)]"""
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        f2 = self.toplayer(c2)
        f1 = up2(f2) + self.lat1(c1)
        f0 = up2(f1) + self.lat0(c0)
        return [self.smooth0(f0), self.smooth1(f1), f2]


class CostRegNet(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.conv0 = ConvBnAct(cin, 8, 3)
        self.conv1 = ConvBnAct(8, 16, 3, s=2)
        self.conv2 = ConvBnAct(16, 16, 3)
        self.conv3 = ConvBnAct(16, 32, 3, s=2)
        self.conv4 = ConvBnAct(32, 32, 3)
        self.conv5 = ConvBnAct(32, 64, 3, s=2)
        self.conv6 = ConvBnAct(64, 64, 3)
        self.conv7 = DeconvBnAct(64, 32)
        self.conv9 = DeconvBnAct(32, 16)
        self.conv11 = DeconvBnAct(16, 8)
        self.prob = QConv3d(8, 1, 3, padding=1)

    def forward(self, x):
        """x (B, C, D, H, W) -> (B, D, H, W)"""
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        c = self.conv6(self.conv5(c4))
        c = c4 + self.conv7(c)
        c = c2 + self.conv9(c)
        c = c0 + self.conv11(c)
        return self.prob(c)[:, 0]


# -- the plane sweep ---------------------------------------------------------

def project(P: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
    """Source-pixel coordinates (x, y), each (B, D, H, W), of the reference
    grid at depths d (B, D, H, W) under P (B, 3, 4)."""
    B, D, H, W = d.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=d.dtype, device=d.device),
                            torch.arange(W, dtype=d.dtype, device=d.device),
                            indexing="ij")
    c = P[:, :, :, None, None, None]                  # (B, 3, 4, 1, 1, 1)
    n = [(c[:, i, 0] * xs + c[:, i, 1] * ys + c[:, i, 2]) * d + c[:, i, 3]
         for i in range(3)]
    behind = n[2] <= 1e-7 * d
    z = torch.where(behind, torch.ones_like(n[2]), n[2])
    x = torch.where(behind, torch.full_like(d, float(W)), n[0] / z)
    y = torch.where(behind, torch.full_like(d, float(H)), n[1] / z)
    return x, y


def _taps(x: Tensor, y: Tensor, H: int, W: int):
    """[(flat index (B, N), weight (B, N))] of the 4 bilinear taps; a tap
    outside the image has weight 0 (and index 0)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = []
    for yt, xt, w in ((y0, x0, (1 - fy) * (1 - fx)), (y0, x0 + 1, (1 - fy) * fx),
                      (y0 + 1, x0, fy * (1 - fx)), (y0 + 1, x0 + 1, fy * fx)):
        ok = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
        idx = torch.where(ok, yt * W + xt, torch.zeros_like(xt)).long()
        out.append((idx, torch.where(ok, w, torch.zeros_like(w))))
    return out


def sample(feat: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Bilinear samples of feat (B, C, H, W) at (x, y) (B, D, H, W) ->
    (B, C, D, H, W)."""
    B, C, H, W = feat.shape
    flat = feat.reshape(B, C, H * W)
    out = 0.0
    for idx, w in _taps(x.reshape(B, -1), y.reshape(B, -1), H, W):
        g = torch.gather(flat, 2, idx[:, None].expand(B, C, idx.shape[1]))
        out = out + g * w[:, None]
    return out.reshape(B, C, *x.shape[1:])


def combine(ref: Tensor, samples: list[Tensor], groups: int) -> Tensor:
    """ref (B, C, 1, H, W), samples [(B, C, D, H, W)] -> the volume
    (B, C or G, D, H, W)."""
    V = len(samples) + 1
    if groups == 1:
        s = ref + sum(samples)
        sq = ref * ref + sum(o * o for o in samples)
        return sq / V - (s / V) ** 2
    B, C = ref.shape[:2]
    acc = sum(o * ref for o in samples)
    return acc.reshape(B, groups, C // groups, *acc.shape[2:]).mean(2) \
        / (V - 1)


class _CostVolume(torch.autograd.Function):
    """The plane-sweep volume over depth chunks; the backward recomputes
    the samples chunk by chunk, so that neither pass holds more than one
    chunk's samples (the volume at B=8 and 640x512 would not fit
    otherwise). Gradients reach the features only."""

    @staticmethod
    def forward(ctx, feats, proj, depth, groups, chunk):
        ctx.save_for_backward(feats, proj, depth)
        ctx.groups, ctx.chunk = groups, chunk
        with torch.no_grad():
            outs = [_volume(feats, proj, depth[:, i:i + chunk], groups)
                    for i in range(0, depth.shape[1], chunk)]
        return torch.cat(outs, 2)

    @staticmethod
    def backward(ctx, grad):
        feats, proj, depth = ctx.saved_tensors
        dfeats = torch.zeros_like(feats)
        for i in range(0, depth.shape[1], ctx.chunk):
            with torch.enable_grad():
                f = feats.detach().requires_grad_(True)
                vol = _volume(f, proj, depth[:, i:i + ctx.chunk], ctx.groups)
                (g,) = torch.autograd.grad(
                    vol, f, grad[:, :, i:i + ctx.chunk])
            dfeats += g
        return dfeats, None, None, None, None


def _volume(feats: Tensor, proj: Tensor, depth: Tensor, groups: int
            ) -> Tensor:
    """feats (B, V, C, H, W), proj (B, V-1, 3, 4), depth (B, D, H, W)."""
    ref = feats[:, 0, :, None]
    samples = []
    for v in range(1, feats.shape[1]):
        x, y = project(proj[:, v - 1], depth)
        samples.append(sample(feats[:, v], x.detach(), y.detach()))
    return combine(ref, samples, groups)


def cost_volume(feats, proj, depth, groups, chunk: int = 8):
    return _CostVolume.apply(feats, proj, depth, groups, chunk)


def depth_window(prev: Tensor, D: int, interval: Tensor) -> Tensor:
    """(B, D, H, W) hypotheses centred on prev (B, H, W), clamped at 1e-7."""
    iv = interval[:, None, None]
    lo = torch.clamp(prev - D / 2 * iv, min=1e-7)
    k = torch.arange(D, dtype=prev.dtype, device=prev.device)
    return lo[:, None] + iv[:, None] * k[None, :, None, None]


def confidence(prob: Tensor) -> Tensor:
    """Mass of the 4 bins idx-1 .. idx+2 around the soft-argmax index idx
    (truncated, clamped to [0, D-1]); no gradient. prob (B, D, H, W)."""
    prob = prob.detach()
    D = prob.shape[1]
    k = torch.arange(D, dtype=prob.dtype, device=prob.device)
    idx = (prob * k[None, :, None, None]).sum(1).long().clamp(0, D - 1)
    pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = pad[:, :-3] + pad[:, 1:-2] + pad[:, 2:-1] + pad[:, 3:]
    return torch.gather(sum4, 1, idx[:, None])[:, 0]


class CascadeMVSNet(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.n_depths = tuple(config["n_depths"])
        self.ratios = tuple(config["interval_ratios"])
        self.groups = config["num_groups"]
        self.levels = config["levels"]
        self.feature = FeatureNet()
        chans = config["feature_channels"]
        for l in range(self.levels):
            self.add_module(f"cost_reg_{l}", CostRegNet(
                chans[l] if self.groups == 1 else self.groups))
        self.set_quant(None)

    def set_quant(self, quant: str | None) -> None:
        self.quant = quant
        for m in self.modules():
            if isinstance(m, QCONVS):
                m.quant = quant

    def forward(self, imgs: Tensor, proj: Tensor, depth_min: Tensor,
                depth_interval: Tensor) -> dict[str, Tensor]:
        """imgs (B, V, H, W, 3); proj (B, V-1, L, 3, 4) fine to coarse;
        depth_min, depth_interval (B,). Returns {'depth_l', 'confidence_l'}
        for l = 0 .. L-1."""
        B, V, H, W, _ = imgs.shape
        feats = self.feature(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2))
        out, prev = {}, None
        for l in reversed(range(self.levels)):
            f = feats[l]
            f = f.reshape(B, V, *f.shape[1:])                # (B, V, C, h, w)
            h, w = f.shape[-2:]
            D = self.n_depths[l]
            interval = depth_interval * self.ratios[l]
            if prev is None:
                k = torch.arange(D, dtype=torch.float32, device=imgs.device)
                depth = (depth_min[:, None] + interval[:, None] * k)[
                    :, :, None, None].expand(B, D, h, w)
            else:
                up = F.interpolate(prev.detach()[:, None], size=(h, w),
                                   mode="bilinear", align_corners=True)[:, 0]
                depth = depth_window(up, D, interval)
            vol = cost_volume(q(f, self.quant), proj[:, :, l], depth,
                              self.groups)
            cost = getattr(self, f"cost_reg_{l}")(q(vol, self.quant))
            prob = torch.softmax(cost, 1)
            prev = (prob * depth).sum(1)
            out[f"depth_{l}"] = prev
            out[f"confidence_{l}"] = confidence(prob)
        return out
