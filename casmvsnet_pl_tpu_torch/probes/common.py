"""What the probes share: the plane scene's level inputs, checks against
the plain versions, timing on the card in turns, and bounds.

A probe's ``main`` returns one :class:`Result` per timed kernel
configuration and raises on the first check that fails.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..utils.flops import PEAK_FLOPS, combine_ops, sample_ops
from ..utils.profiling import card  # noqa: F401  (the probes' card line)

Tensor = torch.Tensor

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
# H100 SXM float32 rate outside the tensor cores
F32_FLOPS = PEAK_FLOPS["NVIDIA H100 80GB HBM3"][torch.float32]
IMG_WH = (640, 512)         # the default config's images


@dataclass
class Result:
    """One timed configuration of a kernel.

    ``group`` names the configuration (a caller sums the results of a group
    over the shapes it covers); ``nbytes`` and ``flops`` are the work of the
    function at these shapes (each input read once, each output written
    once); ``max_abs_err`` is the kernel's float32 error against its plain
    version; ``library_ms`` is one PyTorch call that computes the same
    function, where there is one."""
    kernel: str
    group: str
    label: str
    ms: float
    plain_ms: float
    nbytes: float
    flops: float
    max_abs_err: float
    library_ms: float | None = None


def default_levels(img_wh=IMG_WH):
    """(level, C, D, h, w) of the default config, coarse to fine."""
    W, H = img_wh
    return [(l, 8 << l, d, H >> l, W >> l)
            for l, d in ((2, 48), (1, 32), (0, 8))]


def plane_levels(device, batch: int = 1, img_wh=IMG_WH,
                 n_views: int = 3) -> dict:
    """Per level: (proj (B, V-1, 3, 4), depth windows (B, D, h, w)), built
    the way the cascade builds them, on the plane scene with ``n_views``
    views, repeated B times."""
    from ..data import PlaneScene
    from ..entry import DEPTH_INTERVAL, DEPTH_MIN
    from ..ops import get_depth_values, initial_depth_values, resize_bilinear
    scene = PlaneScene(img_wh=img_wh, n_views=n_views, z0=460.0,
                       baseline=12.0, focal=600.0, slope_x=0.2)
    _, proj, depths = scene.model_inputs()
    proj = torch.from_numpy(proj).to(device)
    out = {}
    for l, C, D, h, w in default_levels(img_wh):
        interval = DEPTH_INTERVAL * 2 ** l
        if l == 2:
            dv = initial_depth_values(DEPTH_MIN, interval, D, 1, h, w,
                                      device=device)
        else:
            # recentre on the next-coarser depth, upsampled x2
            prev = torch.from_numpy(depths[f"level_{l + 1}"]).to(device)
            prev = resize_bilinear(prev[..., None], (h, w))[..., 0]
            dv = get_depth_values(prev, D, interval)
        out[l] = (proj[:, :, l].repeat(batch, 1, 1, 1).contiguous(),
                  dv.repeat(batch, 1, 1, 1).contiguous())
    return out


def bf16_ulp(x: Tensor) -> Tensor:
    """Spacing of bf16 numbers at x (bf16 holds 8 significant bits)."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, torch.full_like(ulp, 2.0 ** -133), ulp)


def check_exact(what: str, got: Tensor, want: Tensor) -> float:
    """Raise unless got equals want bit for bit (shape and dtype too)."""
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel {got.dtype} "
                             f"{tuple(got.shape)} differs from the plain "
                             f"version {want.dtype} {tuple(want.shape)}")
    return 0.0


def check_close(what: str, got: Tensor, want: Tensor, atol: float) -> float:
    """Raise unless |got - want| <= atol everywhere; returns the error."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item() if got.numel() \
        else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max_abs_err {err!r} over {atol}")
    return err


def check_ulp(what: str, got: Tensor, want_f32: Tensor) -> float:
    """Raise unless a bf16 result is within 1 bf16 ulp of the plain f32
    result; returns the largest error in ulps."""
    ulps = ((got.float() - want_f32).abs() / bf16_ulp(want_f32)).max().item()
    if not ulps <= 1.0:
        raise AssertionError(f"{what}: bf16 {ulps!r} ulp from the plain f32 "
                             "result")
    return ulps


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``iters`` calls of fn after one warm-up call,
    by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of fn in microseconds, without waiting for the
    card: what a call costs to enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cv_work(B, V, D, h, w, C, groups, itemsize, backward=False):
    """(bytes, float32 operations) of K1, or of K2 with ``backward``, at one
    level: features, projections and depths read once, the volume (K1) or
    its gradient (K2) read or written once, and K2's float32 feature
    gradient written once. Per sample and source view: 29 operations of
    projection and tap weights and 8C of taps. The backward's own work is
    those samples once and 8C for the scatter."""
    S, n = V - 1, B * D * h * w
    nbytes = (B * V * h * w * C * itemsize + B * S * 12 * 4 + n * 4
              + n * (C if groups == 1 else groups) * itemsize)
    per = sample_ops(S, C, groups)
    if not backward:
        return nbytes, n * per
    return nbytes + B * V * h * w * C * 4, n * (per + 8 * C * S)


def epilogue_work(B, S, D, hw, C, groups, itemsize, backward=False):
    """(bytes, float32 operations) of #3/#5, or of #4/#6 with ``backward``:
    ref, rows and weights read once and the volume written once; the
    backward also reads the volume's gradient and writes d ref (f32), d
    rows and d ws (f32) once. Per (b, d, pixel): 8C per view for the taps;
    the backward's own work is those taps once (#4/#6 compute them twice)
    and 12C per view for d rows and d ws."""
    n = B * D * hw
    cout = C if groups == 1 else groups
    nbytes = (B * hw * C * itemsize + n * S * 4 * C * itemsize + n * S * 16
              + n * cout * itemsize)
    per = 8 * C * S + combine_ops(S, C, groups)
    if not backward:
        return nbytes, n * per
    nbytes += B * hw * C * 4 + n * S * 4 * C * itemsize + n * S * 16
    return nbytes, n * (per + 12 * C * S)


def timed(kernel: str, group: str, label: str, run_k, run_p, work,
          max_abs_err: float, card_name: str, iters=(20, 3), run_lib=None,
          note: str = "") -> Result:
    """Time a kernel against its plain version (and a library call) in
    turns plain, kernel, kernel, plain (``iters`` calls per turn, kernel
    and plain); print both beside the bound of ``work`` = (bytes, float32
    operations) and return the :class:`Result`."""
    k_iters, p_iters = iters
    p1 = cuda_ms(run_p, p_iters)
    k1 = cuda_ms(run_k, k_iters)
    k2 = cuda_ms(run_k, k_iters)
    p2 = cuda_ms(run_p, p_iters)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    lib = None if run_lib is None else cuda_ms(run_lib, k_iters)
    nbytes, flops = work
    b_ms, by = bound(nbytes, flops)
    lib_txt = "" if lib is None else f"library {lib!r} ms; "
    print(f"probe {kernel} {label}: kernel {k_ms!r} ms ({k1!r}, {k2!r}), "
          f"plain {p_ms!r} ms ({p1!r}, {p2!r}); {lib_txt}{note}bound "
          f"{b_ms!r} ms by {by} ({nbytes / 1e6!r} MB, {flops / 1e9!r} GFLOP)"
          f" -> {nbytes / 1e9 / k_ms!r} TB/s, {100 * b_ms / k_ms!r} % of "
          f"bound [{card_name}]", flush=True)
    return Result(kernel, group, label, k_ms, p_ms, nbytes, flops,
                  max_abs_err, lib)
