"""Plane-sweep cost volumes: variance and groupwise correlation.

Counterpart of ``casmvsnet_pl_tpu/ops/plane_sweep.py::build_cost_volume``
and of its hand-written VJP (``_patch_sample`` / ``_patch_sample_bwd``).
A CUDA tensor goes to the fused CUDA kernels (``kernels/cost_volume.py``):
K1 projects, samples and combines in one pass and writes only the finished
volume, and K2, its adjoint, is the backward of a ``torch.autograd.Function``.
A CPU tensor goes to :func:`plain_cost_volume`, K1's plain PyTorch version,
and autograd differentiates it; :func:`plain_cost_volume_bwd` is K2's plain
version, written out.

Gradients reach the features only: the projected coordinates are detached,
as the JAX package's ``_patch_view`` and ``_quad_view`` stop them, so
``proj_mats`` and ``depth_values`` get none.

The quad configuration (``sampling="quad"``, ``CascadeMVSNet(sampling=
"quad")``) has a route of its own, :func:`quad_cost_volume`, the
counterpart of the JAX packed-quad sampler: pack each source view into a
``pack_quad`` table, gather one (4C)-wide row per (pixel, depth, view) and
reduce the rows in the cost epilogue (``ops/cost_epilogue.py``, TPU kernels
#3-#6). The TPU package's other sampler tables (block, window, patch) and
the group-fit fallback chain exist because the TPU gather engine charges
per row; the default path here needs none of them.

The window mode (``sampling="window"``) is a bounded approximation, kept
because the JAX package offers it: where :func:`window_config` allows
(C <= 8), each group of consecutive depths shares one window, and samples
whose bilinear support leaves it are clamped to its edge, as JAX's
``_window_view`` clamps them (:func:`window_sample`,
:func:`window_cost_volume`). Other levels take the exact path. The port
gathers the 4 taps of each clamped point as one row of the view's
``pack_quad`` table (a gather of 16-byte rows, one a tap, took 5x as long
on the card); the JAX strip table (``pack_strips``) exists only for the
TPU gather engine.

The warps of the JAX package's public API are here too:
:func:`warp_src_feature` (the plain sampler, one view) and
:func:`warp_src_quad_batched` (the packed-quad sampler, ``grid_sample_quad``
with TPU kernels #7/#8), whose coordinates are not detached, so that their
gradient reaches ``proj_mat`` and ``depth_values`` as in JAX; and the
single-sample cost volumes :func:`variance_cost_volume` and
:func:`groupwise_cost_volume` over :func:`build_cost_volume`.
"""
from __future__ import annotations

import functools
import warnings

import torch

from ..kernels.cost_volume import (cost_volume_bwd_cuda, cost_volume_cuda,
                                   volume_kind)
from .cost_epilogue import (groupwise_epilogue, groupwise_epilogue_bwd,
                            plain_groupwise_epilogue, plain_variance_epilogue,
                            variance_epilogue, variance_epilogue_bwd)
from .geometry import project_to_src
from .grid_sample import (grid_sample, grid_sample_batched,
                          grid_sample_batched_adjoint, grid_sample_quad,
                          pack_quad, pack_quad_adjoint, quad_weights)

Tensor = torch.Tensor


def warp_src_feature(src_feat: Tensor, proj_mat: Tensor,
                     depth_values: Tensor) -> Tensor:
    """Warp one source feature map over all depth hypotheses with the plain
    sampler: src_feat (H, W, C), proj_mat (3, 4), depth_values (D, H, W) ->
    (D, H, W, C) in src_feat's dtype."""
    H, W = src_feat.shape[:2]
    xy = project_to_src(proj_mat, depth_values, H, W)
    return grid_sample(src_feat, xy).to(src_feat.dtype)


def warp_src_quad_batched(src_quad: Tensor, proj_mat: Tensor,
                          depth_values: Tensor, height: int,
                          width: int) -> Tensor:
    """Batched warp through pre-packed quad tables: src_quad (B, H+1, W+1,
    4C) from ``pack_quad``, proj_mat (B, 3, 4), depth_values (B, D, H, W)
    -> (B, D, H, W, C) in src_quad's dtype. Differentiable with respect to
    all three."""
    xy = project_to_src(proj_mat, depth_values, height, width)
    return grid_sample_quad(src_quad, xy, height, width)


def variance_cost_volume(feats: Tensor, proj_mats: Tensor,
                         depth_values: Tensor) -> Tensor:
    """Variance cost volume of one sample: feats (V, H, W, C), reference
    first; proj_mats (V-1, 3, 4); depth_values (D, H, W) -> (D, H, W, C)."""
    return build_cost_volume(feats[None], proj_mats[None],
                             depth_values[None])[0]


def groupwise_cost_volume(feats: Tensor, proj_mats: Tensor,
                          depth_values: Tensor, groups: int) -> Tensor:
    """Groupwise-correlation cost volume of one sample: shapes as
    :func:`variance_cost_volume` -> (D, H, W, G)."""
    return build_cost_volume(feats[None], proj_mats[None],
                             depth_values[None], groups)[0]


def _source_coords(proj_mats: Tensor, depth_values: Tensor, H: int,
                   W: int) -> list[Tensor]:
    """Per source view, the (B, D, H, W, 2) sample coordinates, detached."""
    return [project_to_src(proj_mats[:, v], depth_values, H, W).detach()
            for v in range(proj_mats.shape[1])]


def plain_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                      groups: int = 1, kind: str | None = None) -> Tensor:
    """Cost volume from per-view warps, accumulated in float32.

    feats: (B, V, H, W, C), reference view first; proj_mats: (B, V-1, 3, 4);
    depth_values: (B, D, H, W). ``kind`` "variance" (None at groups == 1):
    (B, D, H, W, C), the variance sum(f^2)/V - (sum(f)/V)^2 with the
    un-warped reference view included; "groupwise" (None at groups > 1):
    (B, D, H, W, G), the mean over each group of C/G consecutive channels of
    warped * ref, summed over source views and divided by V-1 (G = 1: the
    mean over all C channels, TransMVSNet's correlation). The result is in
    the features' dtype.
    """
    B, V, H, W, C = feats.shape
    D = depth_values.shape[1]
    variance = volume_kind(kind, groups) == "variance"
    f = feats.float()
    ref = f[:, 0].unsqueeze(1)                               # (B, 1, H, W, C)
    if variance:
        s = ref.expand(B, D, H, W, C)
        sq = s * s
    else:
        if C % groups:
            raise ValueError(f"C={C} is not divisible by groups={groups}")
        acc = feats.new_zeros((B, D, H, W, groups), dtype=torch.float32)
    for v, xy in enumerate(_source_coords(proj_mats, depth_values, H, W)):
        o = grid_sample_batched(f[:, v + 1], xy)             # (B, D, H, W, C)
        if variance:
            s = s + o
            sq = sq + o * o
        else:
            prod = (o * ref).reshape(B, D, H, W, groups, C // groups)
            acc = acc + prod.sum(-1) * (groups / C)
    # Multiplying by the f32 reciprocal (not dividing) is what the kernel
    # does, and what torch does anyway for a CUDA tensor over a scalar.
    if variance:
        m = s * (1.0 / V)
        out = sq * (1.0 / V) - m * m
    else:
        out = acc * (1.0 / (V - 1))
    return out.to(feats.dtype)


def plain_cost_volume_bwd(feats: Tensor, proj_mats: Tensor,
                          depth_values: Tensor, grad_out: Tensor,
                          groups: int = 1, kind: str | None = None) -> Tensor:
    """The gradient of :func:`plain_cost_volume` with respect to feats,
    written out as K2 computes it: recompute the samples o_v, take the
    combine's adjoint, and scatter each source sample's share onto its
    taps (``grid_sample_batched_adjoint``, a float32 ``index_add_``).

    With s = ref + sum_v o_v, m = s / V and g = grad_out:
      variance:  d ref = sum_d g (2/V) (ref - m); d o_v = g (2/V) (o_v - m);
      groupwise: g_c = g[c // k] / (k (V-1)), k = C/G;
                 d ref[c] = sum_d g_c sum_v o_v[c]; d o_v[c] = g_c ref[c].
    Returns (B, V, H, W, C) in the feats dtype, accumulated in float32.
    """
    B, V, H, W, C = feats.shape
    f = feats.float()
    g = grad_out.float()
    ref = f[:, 0].unsqueeze(1)                               # (B, 1, H, W, C)
    coords = _source_coords(proj_mats, depth_values, H, W)
    samples = [grid_sample_batched(f[:, v + 1], xy)
               for v, xy in enumerate(coords)]               # (B, D, H, W, C)
    if volume_kind(kind, groups) == "variance":
        s = ref
        for o in samples:
            s = s + o
        m = s * (1.0 / V)
        gs = g * (2.0 / V)
        d_ref = (gs * (ref - m)).sum(1)
        d_src = [gs * (o - m) for o in samples]
    else:
        if C % groups:
            raise ValueError(f"C={C} is not divisible by groups={groups}")
        k = C // groups
        gc = (g * (1.0 / (k * (V - 1)))).repeat_interleave(k, dim=-1)
        so = samples[0]
        for o in samples[1:]:
            so = so + o
        d_ref = (gc * so).sum(1)
        d_src = [gc * ref] * (V - 1)
    grad = [d_ref] + [grid_sample_batched_adjoint(d, xy, H, W)
                      for d, xy in zip(d_src, coords)]
    return torch.stack(grad, dim=1).to(feats.dtype)


class _CostVolume(torch.autograd.Function):
    """K1 forward, K2 backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, feats, proj_mats, depth_values, groups, kind=None):
        ctx.save_for_backward(feats, proj_mats, depth_values)
        ctx.groups, ctx.kind = groups, kind
        return cost_volume_cuda(feats, proj_mats, depth_values, groups, kind)

    @staticmethod
    def backward(ctx, grad_out):
        feats, proj_mats, depth_values = ctx.saved_tensors
        d_feats = cost_volume_bwd_cuda(feats, proj_mats, depth_values,
                                       grad_out.contiguous(), ctx.groups,
                                       ctx.kind)
        return d_feats, None, None, None, None


def quad_rows(feats: Tensor, proj_mats: Tensor, depth_values: Tensor
              ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The cost epilogue's inputs in the quad configuration.

    Counterpart of the JAX ``_quad_view`` / ``_quad_sample`` forward up to
    its ``_tap_reduce``: project (coordinates detached), ``quad_weights``,
    and one row gather from the ``pack_quad`` tables of the source views.
    Shapes as in :func:`plain_cost_volume`. Returns ref (B, hw, C); rows
    (B, S, D, hw, 4C) in the features' dtype, S = V-1; ws (B, S, D, hw, 4)
    float32; and idx (B*S*D*hw,) int64, each row's index in the tables
    flattened to (B*S*(H+1)*(W+1), 4C).
    """
    B, V, H, W, C = feats.shape
    S, D = V - 1, depth_values.shape[1]
    Hq, Wq = H + 1, W + 1
    xy = project_to_src(proj_mats, depth_values[:, None], H, W).detach()
    w4, y0i, x0i = quad_weights(xy, H, W)                 # (B, S, D, H, W)
    base = torch.arange(B * S, device=feats.device).reshape(B, S, 1, 1, 1)
    idx = (base * (Hq * Wq) + y0i * Wq + x0i).reshape(-1)
    tables = pack_quad(feats[:, 1:]).reshape(B * S * Hq * Wq, 4 * C)
    rows = tables.index_select(0, idx).reshape(B, S, D, H * W, 4 * C)
    ref = feats[:, 0].reshape(B, H * W, C).contiguous()
    return ref, rows, w4.reshape(B, S, D, H * W, 4).contiguous(), idx


def plain_quad_cost_volume(feats: Tensor, proj_mats: Tensor,
                           depth_values: Tensor, groups: int = 1) -> Tensor:
    """The quad route in plain PyTorch, differentiated by autograd (its
    gather's backward included): :func:`quad_rows`, then the plain cost
    epilogue. Shapes and result as :func:`plain_cost_volume`."""
    B, V, H, W, C = feats.shape
    ref, rows, ws, _ = quad_rows(feats, proj_mats, depth_values)
    if groups == 1:
        out = plain_variance_epilogue(ref, rows, ws)
    else:
        out = plain_groupwise_epilogue(ref, rows, ws, groups)
    return out.reshape(B, depth_values.shape[1], H, W, -1)


class _QuadCostVolume(torch.autograd.Function):
    """The quad route: TPU kernel #3 (variance) or #5 (groupwise) forward,
    #4 or #6 backward, through the dispatchers of ``ops/cost_epilogue.py``
    (the CUDA kernels for a CUDA tensor, the plain versions for a CPU one).

    It saves (ref, rows, ws) as the JAX epilogue's VJP does, and the row
    indices for the scatter. The backward adds each view's d rows into a
    float32 table gradient with ``index_add_``, as ``_quad_sample_bwd``
    scatters in float32, takes the adjoint of ``pack_quad`` and casts once.
    The epilogue's d ws is dropped: the weights come from detached
    coordinates.
    """

    @staticmethod
    def forward(ctx, feats, proj_mats, depth_values, groups):
        B, V, H, W, C = feats.shape
        ref, rows, ws, idx = quad_rows(feats, proj_mats, depth_values)
        ctx.save_for_backward(ref, rows, ws, idx)
        ctx.groups = groups
        ctx.shape = feats.shape
        if groups == 1:
            out = variance_epilogue(ref, rows, ws)
        else:
            out = groupwise_epilogue(ref, rows, ws, groups)
        return out.reshape(B, depth_values.shape[1], H, W, -1)

    @staticmethod
    def backward(ctx, grad_out):
        ref, rows, ws, idx = ctx.saved_tensors
        B, V, H, W, C = ctx.shape
        S, D = rows.shape[1:3]
        g = grad_out.to(ref.dtype).reshape(B, D, H * W, -1).contiguous()
        if ctx.groups == 1:
            d_ref, d_rows, _ = variance_epilogue_bwd(ref, rows, ws, g)
        else:
            d_ref, d_rows, _ = groupwise_epilogue_bwd(ref, rows, ws, g,
                                                      ctx.groups)
        table = torch.zeros((B * S * (H + 1) * (W + 1), 4 * C),
                            dtype=torch.float32, device=ref.device)
        idx = idx.reshape(B, S, -1)
        for v in range(S):                  # one view's f32 rows at a time
            table.index_add_(0, idx[:, v].reshape(-1),
                             d_rows[:, v].reshape(-1, 4 * C).float())
        d_src = pack_quad_adjoint(table.reshape(B, S, H + 1, W + 1, 4 * C))
        d_feats = torch.cat([d_ref.reshape(B, 1, H, W, C), d_src], dim=1)
        return d_feats.to(ref.dtype), None, None, None


def quad_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                     groups: int = 1) -> Tensor:
    """Differentiable cost volume of the quad configuration (see
    :class:`_QuadCostVolume`). Shapes and result as
    :func:`plain_cost_volume`."""
    return _QuadCostVolume.apply(feats, proj_mats, depth_values, groups)


# ---------------------------------------------------------------------------
# The window mode (sampling="window"): a bounded approximation
# ---------------------------------------------------------------------------

def window_config(C: int, D: int, window_h: int = 4):
    """The window mode's config of a level, or None where it does not apply.

    Counterpart of ``casmvsnet_pl_tpu/ops/plane_sweep.py::window_config``:
    None for C > 8 or where D does not divide into groups of min(D, 8);
    else {"strip_w": min(16, 128 // C), "window_h": window_h,
    "depth_group": min(D, 8)}.
    """
    if C > 8:
        return None
    group = min(D, 8)
    if D % group:
        return None
    return {"strip_w": min(16, 128 // C), "window_h": window_h,
            "depth_group": group}


def _window_frame(xy: Tensor, height: int, width: int, strip_w: int,
                  window_h: int, depth_group: int):
    """Each sample's window origin and clamped offset in it.

    xy (B, D, H, W, 2) float32 -> (x_org, y_org (B, ng, 1, hw); fx, fy,
    valid (B, ng, depth_group, hw)), as JAX's ``_window_view`` computes
    them: the group's origin is the floor of its smallest valid coordinate
    (1e9 where it has none), clipped to [-1, W-1] / [-1, H-1]; the offsets
    are clipped to the window; validity is tested on the unclamped point.
    """
    B, D = xy.shape[:2]
    shape = (B, D // depth_group, depth_group, height * width)
    x = xy[..., 0].float().reshape(shape)
    y = xy[..., 1].float().reshape(shape)
    valid = (x > -1.0) & (x < float(width)) & (y > -1.0) & (y < float(height))
    big = torch.full((), 1e9, dtype=torch.float32, device=xy.device)
    minx = torch.where(valid, x, big).amin(2, keepdim=True)
    miny = torch.where(valid, y, big).amin(2, keepdim=True)
    x_org = torch.clamp(torch.floor(minx), -1.0, width - 1.0)
    y_org = torch.clamp(torch.floor(miny), -1.0, height - 1.0)
    fx = torch.clamp(x - x_org, 0.0, strip_w - 1.0)
    fy = torch.clamp(y - y_org, 0.0, window_h - 1.0)
    return x_org, y_org, fx, fy, valid


def _window_quad(xy: Tensor, height: int, width: int, strip_w: int,
                 window_h: int, depth_group: int):
    """The quad cell and the 4 tap weights of each sample's clamped point
    (x_org + fx, y_org + fy): (row index (B, N) int64 into the flattened
    ``pack_quad`` table of one sample, weights (B, N, 4) float32 in
    ``pack_quad``'s tap order y0x0, y0x1, y1x0, y1x1), N = D * H * W.

    A weight is JAX's hat product ``max(0, 1 - |fx - k|) * valid *
    max(0, 1 - |fy - j|)`` at the window column k and row j of the tap,
    so it is bit-equal to the lane weight JAX computes there; the window's
    other columns and rows have hat 0. A tap outside the image has weight
    0, as JAX reads its strips' zero padding there; a cell outside the
    table clamps onto its edge, where every weight is 0.
    """
    x_org, y_org, fx, fy, valid = _window_frame(
        xy, height, width, strip_w, window_h, depth_group)
    B = xy.shape[0]
    vm = valid.float()
    kx0, ky0 = torch.floor(fx), torch.floor(fy)
    zero = torch.zeros_like(fx)
    hats = []
    for axis, (f, k0, org, n) in enumerate(((fx, kx0, x_org, width),
                                            (fy, ky0, y_org, height))):
        taps = []
        for k in (k0, k0 + 1):
            hat = torch.clamp(1.0 - torch.abs(f - k), min=0.0)
            p = org + k
            taps.append(torch.where((p >= 0) & (p <= n - 1),
                                    hat * vm if axis == 0 else hat, zero))
        hats.append(taps)
    (wx0, wx1), (wy0, wy1) = hats
    w4 = torch.stack([wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1], dim=-1)
    x0i = torch.clamp(x_org + kx0 + 1, 0, width).long()
    y0i = torch.clamp(y_org + ky0 + 1, 0, height).long()
    idx = y0i * (width + 1) + x0i
    return idx.reshape(B, -1), w4.reshape(B, -1, 4)


class _WindowSample(torch.autograd.Function):
    """The window sampler of one source view, differentiated by hand.

    Forward: one gathered row of the view's ``pack_quad`` table holds the
    clamped point's 4 taps; per x-tap, the two y-taps' products ``feature
    * weight`` (the weight rounded to the features' dtype) are added in
    that dtype, and the two x-taps' partial sums in float32: JAX's
    rounding (its rows are summed over the window's rows in the table
    dtype and over its columns by a float32 ``dot_general``). Backward:
    each tap's share ``grad * weight`` added into a float32 table gradient
    with ``index_add_``, taken through ``pack_quad``'s adjoint and cast
    once, as ``_QuadCostVolume`` scatters; the coordinates get none.
    """

    @staticmethod
    def forward(ctx, src, xy, cfg):
        B, H, W, C = src.shape
        idx, w4 = _window_quad(xy, H, W, **cfg)
        base = (torch.arange(B, device=src.device)
                * ((H + 1) * (W + 1)))[:, None]
        table = pack_quad(src).reshape(-1, 4 * C)
        rows = table.index_select(0, (idx + base).reshape(-1))
        t = rows.reshape(B, -1, 4, C) * w4.to(src.dtype)[..., None]
        out = (t[:, :, 0] + t[:, :, 2]).float() + (t[:, :, 1]
                                                   + t[:, :, 3]).float()
        ctx.save_for_backward(xy)
        ctx.cfg, ctx.shape, ctx.dtype = cfg, src.shape, src.dtype
        return out.reshape(B, xy.shape[1], H * W, C)

    @staticmethod
    def backward(ctx, grad):
        xy, = ctx.saved_tensors
        B, H, W, C = ctx.shape
        idx, w4 = _window_quad(xy, H, W, **ctx.cfg)
        base = (torch.arange(B, device=grad.device)
                * ((H + 1) * (W + 1)))[:, None]
        d_rows = (grad.float().reshape(B, -1, 1, C)
                  * w4.to(ctx.dtype).float()[..., None])
        table = torch.zeros((B * (H + 1) * (W + 1), 4 * C),
                            dtype=torch.float32, device=grad.device)
        table.index_add_(0, (idx + base).reshape(-1),
                         d_rows.reshape(-1, 4 * C))
        d_src = pack_quad_adjoint(table.reshape(B, H + 1, W + 1, 4 * C))
        return d_src.to(ctx.dtype), None, None


def window_sample(src: Tensor, xy: Tensor, cfg: dict) -> Tensor:
    """Sample one source view with the window mode's clamps.

    Counterpart of ``casmvsnet_pl_tpu/ops/plane_sweep.py::_window_view``
    after its projection: src (B, H, W, C), xy (B, D, H, W, 2) float32
    source-pixel coordinates (their gradient is not taken), cfg from
    :func:`window_config`. Returns (B, D, H*W, C) float32: a zeros-padded
    bilinear sample at each sample's clamped point (x_org + fx,
    y_org + fy), times the validity of the unclamped point. It equals the
    exact sample wherever the group's span fits the window.
    """
    return _WindowSample.apply(src, xy.detach(), cfg)


def window_overflow(xy: Tensor, height: int, width: int, strip_w: int,
                    window_h: int, depth_group: int) -> Tensor:
    """(B, ng, hw) bool: the groups in which a valid sample's offset was
    clamped, so that the window mode's result there is not the exact
    bilinear sample. xy (B, D, H, W, 2)."""
    x_org, y_org, fx, _, valid = _window_frame(xy, height, width, strip_w,
                                               window_h, depth_group)
    x = xy[..., 0].float().reshape(fx.shape)
    y = xy[..., 1].float().reshape(fx.shape)
    clamped = (x - x_org > strip_w - 1.0) | (y - y_org > window_h - 1.0)
    return (clamped & valid).any(2)


@functools.cache
def _warn_window_once() -> None:
    """One warning a process that the window mode is an approximation (the
    text of the JAX package's ``_warn_window_once``)."""
    warnings.warn(
        "sampling='window' clamps samples to the strip window edge when a "
        "depth-group's span exceeds the window; results are exact only "
        "while group spans fit (see ops/plane_sweep.py window notes).",
        stacklevel=3)


def window_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                       groups: int, cfg: dict, kind: str | None = None
                       ) -> Tensor:
    """The cost volume of a level in the window mode, combined as the JAX
    ``batched_variance_cost_volume`` / ``batched_groupwise_cost_volume``
    combine it: the reference view first, then the source views in order,
    sums in float32, cast once. Shapes, ``kind`` and result as
    :func:`plain_cost_volume`; differentiable with respect to feats."""
    B, V, H, W, C = feats.shape
    D = depth_values.shape[1]
    variance = volume_kind(kind, groups) == "variance"
    ref = feats[:, 0].reshape(B, 1, H * W, C).float()
    if variance:
        s = ref.expand(B, D, H * W, C)
        sq = s * s
    else:
        if C % groups:
            raise ValueError(f"C={C} is not divisible by groups={groups}")
        acc = feats.new_zeros((B, D, H * W, groups), dtype=torch.float32)
    for v, xy in enumerate(_source_coords(proj_mats, depth_values, H, W)):
        o = window_sample(feats[:, v + 1], xy, cfg)       # (B, D, hw, C)
        if variance:
            s = s + o
            sq = sq + o * o
        else:
            k = C // groups
            prod = (o * ref).reshape(B, D, H * W, groups, k)
            acc = acc + (prod * (1.0 / k)).sum(-1)
    # XLA divides by the constant V as a product with its float32
    # reciprocal; so does this, to the bit.
    if variance:
        out = sq * (1.0 / V) - (s * (1.0 / V)) ** 2
    else:
        out = acc * (1.0 / (V - 1))
    return out.to(feats.dtype).reshape(B, D, H, W, -1)


def build_cost_volume(feats: Tensor, proj_mats: Tensor, depth_values: Tensor,
                      groups: int = 1, sampling: str = "auto",
                      kind: str | None = None) -> Tensor:
    """Differentiable cost volume. Shapes and ``kind`` as in
    :func:`plain_cost_volume`.

    sampling "auto" or "patch": the CUDA kernels (K1 forward, K2 backward)
    for a CUDA tensor, the plain version under autograd for a CPU tensor;
    exact bilinear, as the JAX patch path is. "quad": :func:`quad_cost_volume`
    (no one-group correlation). "window": :func:`window_cost_volume` where
    :func:`window_config` allows (a warning once a process), else the exact
    path of "auto", as JAX falls back to its exact samplers.
    """
    kind = volume_kind(kind, groups)
    if sampling == "quad":
        if kind == "groupwise" and groups == 1:
            raise ValueError("sampling='quad' has no one-group correlation; "
                             "use 'auto'")
        return quad_cost_volume(feats, proj_mats, depth_values, groups)
    if sampling == "window":
        cfg = window_config(feats.shape[-1], depth_values.shape[1])
        if cfg is not None:
            _warn_window_once()
            return window_cost_volume(feats, proj_mats, depth_values, groups,
                                      cfg, kind)
    elif sampling not in ("auto", "patch"):
        raise ValueError(f"unknown sampling mode {sampling!r}")
    if feats.is_cuda:
        return _CostVolume.apply(feats, proj_mats, depth_values, groups, kind)
    return plain_cost_volume(feats, proj_mats, depth_values, groups, kind)
