"""The CUDA cost-volume kernels (K1 forward, K2 backward), the quad
configuration's cost epilogues (TPU kernels #3-#6), the packed-quad
sampler's weighted 4-tap reduce (#7/#8) and the probe kernels (#9-#13)
against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import (cost_volume_bwd_cuda,
                                            cost_volume_cuda,
                                            groupwise_epilogue_bwd_cuda,
                                            groupwise_epilogue_cuda,
                                            lane_gather_cuda,
                                            lane_prefix_copy_cuda,
                                            patch_epilogue_t_cuda,
                                            row_gather_bulk_cuda,
                                            row_gather_cp_async_cuda,
                                            row_gather_ldg_cuda,
                                            tap_reduce_bwd_cuda,
                                            tap_reduce_cuda,
                                            variance_dblk_cuda,
                                            variance_epilogue_bwd_cuda,
                                            variance_epilogue_cuda,
                                            variance_v3_cuda)
from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce
from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr
from casmvsnet_pl_tpu_torch.ops import get_depth_values, resize_bilinear
from casmvsnet_pl_tpu_torch.ops.grid_sample import (pack_quad,
                                                    plain_grid_sample_quad)
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (build_cost_volume,
                                                    plain_cost_volume,
                                                    plain_cost_volume_bwd,
                                                    plain_quad_cost_volume,
                                                    project_to_src, quad_rows,
                                                    warp_src_quad_batched)
from casmvsnet_pl_tpu_torch.probes import epi3, epi5, gather

pytestmark = pytest.mark.cuda

GEOMETRIES = {   # as tests/test_torch_port_cost_volume.py, plus a border case
    "translation": dict(tx=40.0, ty=12.0, dmin=430.0, dint=2.65),
    "absurd_baseline": dict(tx=900.0, ty=0.0, dmin=30.0, dint=8.0),
    "negative_depth": dict(tx=40.0, ty=12.0, dmin=-9.0, dint=2.65),
    "border": dict(tx=-12000.0, ty=300.0, dmin=430.0, dint=2.65),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def translations(rng, B, V, tx, ty):
    """(B, V-1, 3, 4) f32 projections: identity rotation, translation (tx,
    ty) per source view (scalars or (V-1,)), and the second sample's
    rotations perturbed by 0.01 N(0, 1) from ``rng``."""
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32),
                   (B, V - 1, 1, 1))
    proj[..., 0, 3] = tx
    proj[..., 1, 3] = ty
    proj[1, :, :3, :3] += rng.randn(V - 1, 3, 3).astype(np.float32) * 0.01
    return proj


def per_pixel_depths(rng, B, D, H, W, interval):
    """(B, D, H, W) f32 depth windows as the cascade's lower levels build
    them: a smooth coarser map with a step edge (each sample 30 deeper than
    the last), upsampled x2 and recentred (ops.get_depth_values)."""
    h, w = (H + 1) // 2, (W + 1) // 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coarse = (450.0 + 15.0 * np.sin(xx / 3.0 + rng.rand())
              + 10.0 * np.cos(yy / 4.0) + 40.0 * (xx > w / 2))
    coarse = coarse[None] + 30.0 * np.arange(B, dtype=np.float32)[:, None,
                                                                   None]
    prev = resize_bilinear(torch.from_numpy(coarse.astype(np.float32))[
        ..., None], (H, W))[..., 0]
    return get_depth_values(prev, D, interval).numpy()


def _scene(C, D, tx, ty, dmin, dint, B=2, V=3, H=20, W=36, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(B, V, H, W, C).astype(np.float32)
    proj = translations(rng, B, V, tx, ty)
    dv = ((dmin + dint * np.arange(D, dtype=np.float32))[None, :, None, None]
          * np.ones((B, D, H, W), np.float32))
    return (torch.from_numpy(a).cuda() for a in (feats, proj, dv))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_kernel_matches_plain(cuda, C, groups, geometry):
    feats, proj, dv = _scene(C, 8, **GEOMETRIES[geometry])
    before = cost_volume_cuda.launches
    got = build_cost_volume(feats, proj, dv, groups)
    assert cost_volume_cuda.launches == before + 1
    ref = plain_cost_volume(feats, proj, dv, groups)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    fb = feats.to(torch.bfloat16)
    got_b = cost_volume_cuda(fb, proj, dv, groups)
    ref_b = plain_cost_volume(fb.float(), proj, dv, groups)
    assert got_b.dtype == torch.bfloat16
    # within one bf16 ulp of the f32 result (8 significant bits)
    ulp = torch.ldexp(torch.ones_like(ref_b), torch.frexp(ref_b)[1] - 8)
    assert bool(((got_b.float() - ref_b).abs() <= ulp).all())


def bf16_ulp(x):
    """Spacing of bf16 numbers at x (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - 8)


# K2 adds the source views' shares with atomics, in an order that changes
# from run to run: f32 agrees with the plain backward to rounding (1e-5 at
# unit-scale inputs), and a bf16 result within 2 bf16 ulps of the plain f32
# backward of the same bf16 inputs, rounded, or within the f32 bound where
# cancellation leaves a value so small that the summation order moves it
# by more than 2 of its ulps.
BWD_TOL = 1e-5


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_bwd_kernel_matches_plain(cuda, C, groups, geometry):
    feats, proj, dv = _scene(C, 8, **GEOMETRIES[geometry])
    g = torch.Generator(device="cuda").manual_seed(C + groups)
    shape = (2, 8, 20, 36, C if groups == 1 else groups)
    go = torch.randn(shape, generator=g, device="cuda")
    before = cost_volume_bwd_cuda.launches
    got = cost_volume_bwd_cuda(feats, proj, dv, go, groups)
    assert cost_volume_bwd_cuda.launches == before + 1
    ref = plain_cost_volume_bwd(feats, proj, dv, go, groups)
    assert got.shape == feats.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    fb, gb = feats.to(torch.bfloat16), go.to(torch.bfloat16)
    got_b = cost_volume_bwd_cuda(fb, proj, dv, gb, groups)
    ref_b = plain_cost_volume_bwd(fb.float(), proj, dv, gb.float(), groups
                                  ).to(torch.bfloat16).float()
    assert got_b.dtype == torch.bfloat16
    err = (got_b.float() - ref_b).abs()
    assert bool((err <= 2 * bf16_ulp(ref_b) + BWD_TOL).all())


@pytest.mark.parametrize("groups", [1, 8])
def test_autograd_function_matches_plain_autograd(cuda, groups):
    feats, proj, dv = _scene(16, 8, **GEOMETRIES["translation"])
    g = torch.Generator(device="cuda").manual_seed(7)
    feats = feats.requires_grad_(True)
    launches = cost_volume_cuda.launches, cost_volume_bwd_cuda.launches
    out = build_cost_volume(feats, proj, dv, groups)
    go = torch.randn(out.shape, generator=g, device="cuda")
    got, = torch.autograd.grad(out, feats, go)
    assert (cost_volume_cuda.launches, cost_volume_bwd_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref, = torch.autograd.grad(plain_cost_volume(feats, proj, dv, groups),
                               feats, go)
    torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    # bf16 features: the gradient comes back in the features' dtype
    fb = feats.detach().to(torch.bfloat16).requires_grad_(True)
    out_b = build_cost_volume(fb, proj, dv, groups)
    gb, = torch.autograd.grad(out_b, fb, go.to(torch.bfloat16))
    assert out_b.dtype == gb.dtype == torch.bfloat16


def _bwd_scene(scene, C, seed=0):
    """(feats, proj, dv) on the card, B=2: "per_pixel", L1-like per-pixel
    depth windows (D=32, a 3-px spread of disparity); "v5", five views, a
    depth range per sample; "odd", 21x37 pixels, no multiple of a block;
    "wide", a source camera that magnifies the reference 12x over an
    L2-like span (D=48), so that a pixel's footprint jumps by many pixels
    from one depth to the next and leaves the image."""
    rng = np.random.RandomState(seed)
    V, H, W = (5, 24, 40) if scene == "v5" else (3, 21, 37) \
        if scene == "odd" else (3, 24, 40)
    feats = rng.rand(2, V, H, W, C).astype(np.float32)
    if scene == "v5":
        proj = translations(rng, 2, V, np.array([1500.0, -1500.0, 600.0,
                                                 -900.0]),
                            np.array([200.0, -300.0, 700.0, 0.0]))
        steps = np.arange(16, dtype=np.float32)[None, :, None, None]
        dv = np.array([430.0, 700.0], np.float32)[:, None, None, None] \
            + np.array([2.65, 5.3], np.float32)[:, None, None, None] * steps
        dv = np.broadcast_to(dv, (2, 16, H, W))
    elif scene == "wide":
        proj = translations(rng, 2, V, 9000.0, 0.0)
        proj[..., 0, :3] = [12.0, 0.0, -11.0 * (W - 1) / 2]
        proj[..., 1, :3] = [0.0, 12.0, -11.0 * (H - 1) / 2]
        dv = np.broadcast_to((425.0 + 10.6 * np.arange(48, dtype=np.float32))[
            None, :, None, None], (2, 48, H, W))
    else:
        proj = translations(rng, 2, V, 3000.0, 400.0)
        dv = per_pixel_depths(rng, 2, 32, H, W, 5.3)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
                 for a in (feats, proj, dv))


@pytest.mark.parametrize("scene", ["per_pixel", "v5", "odd", "wide"])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_bwd_kernel_scenes_match_plain(cuda, scene, groups):
    """K2 against its plain version at C = 8, 16, 32, B=2 (V = 3 with its
    register runs, V = 5 without): f32 within 1e-5 abs + rel, bf16 within 2
    ulps of the rounded plain result (+ 1e-5)."""
    for C in (8, 16, 32):
        feats, proj, dv = _bwd_scene(scene, C, seed=C + groups)
        D = dv.shape[1]
        g = torch.Generator(device="cuda").manual_seed(C * groups)
        go = torch.randn((2, D) + feats.shape[2:4]
                         + (C if groups == 1 else groups,), generator=g,
                         device="cuda")
        ref = plain_cost_volume_bwd(feats, proj, dv, go, groups)
        before = cost_volume_bwd_cuda.launches
        got = cost_volume_bwd_cuda(feats, proj, dv, go, groups)
        assert cost_volume_bwd_cuda.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL,
                                   msg=f"C={C}")
        fb, gb = feats.to(torch.bfloat16), go.to(torch.bfloat16)
        got_b = cost_volume_bwd_cuda(fb, proj, dv, gb, groups)
        ref_b = plain_cost_volume_bwd(fb.float(), proj, dv, gb.float(),
                                      groups).to(torch.bfloat16).float()
        err = (got_b.float() - ref_b).abs()
        assert bool((err <= 2 * bf16_ulp(ref_b) + BWD_TOL).all()), C


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    go = torch.zeros(2, 8, 20, 36, 8, device="cuda")
    with pytest.raises(ValueError, match="grad_out"):
        cost_volume_bwd_cuda(feats, proj, dv, go.to(torch.bfloat16))
    with pytest.raises(ValueError, match="grad_out"):
        cost_volume_bwd_cuda(feats, proj, dv, go[..., :4].contiguous(),
                             groups=1)
    with pytest.raises(ValueError, match="contiguous"):
        cost_volume_bwd_cuda(feats, proj, dv, go.transpose(2, 3)
                             .contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="autograd"):
        cost_volume_cuda(feats.requires_grad_(True), proj, dv)


def test_kernel_rejects_what_it_does_not_take(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    with pytest.raises(ValueError, match="contiguous"):
        cost_volume_cuda(feats, proj, dv.transpose(2, 3).contiguous()
                         .transpose(2, 3))
    with pytest.raises(ValueError, match="C="):
        cost_volume_cuda(torch.cat([feats, feats[..., :4]], -1), proj, dv)
    with pytest.raises(ValueError, match="groups"):
        cost_volume_cuda(feats, proj, dv, groups=3)
    with pytest.raises(ValueError, match="proj_mats"):
        cost_volume_cuda(feats, proj.double(), dv)


def _epilogues(groups):
    """(kernel, plain, kernel bwd, plain bwd) of #3/#4 (groups == 1) or
    #5/#6, the plain ones taking the kernels' arguments."""
    if groups == 1:
        return (variance_epilogue_cuda, ce.plain_variance_epilogue,
                variance_epilogue_bwd_cuda, ce.plain_variance_epilogue_bwd)
    return (groupwise_epilogue_cuda,
            lambda *a: ce.plain_groupwise_epilogue(*a, groups),
            groupwise_epilogue_bwd_cuda,
            lambda *a: ce.plain_groupwise_epilogue_bwd(*a, groups))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_epilogue_kernels_match_plain(cuda, C, groups, geometry):
    """#3/#5 and #4/#6 on the rows and weights of the quad route: f32 within
    1e-5, bf16 within 1 ulp (forward) or 2 ulps + 1e-5 (backward) of the
    plain f32 result on the same bf16 inputs. No atomics: the backward
    differs from its plain version only in the order of its sums."""
    feats, proj, dv = _scene(C, 8, **GEOMETRIES[geometry])
    ref, rows, ws, _ = quad_rows(feats, proj, dv)
    kernel, plain, kernel_bwd, plain_bwd = _epilogues(groups)
    before = kernel.launches, kernel_bwd.launches
    got = kernel(ref, rows, ws, groups)
    torch.testing.assert_close(got, plain(ref, rows, ws), rtol=0, atol=1e-5)
    rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
    got_b = kernel(rb, rowsb, ws, groups)
    want_b = plain(rb.float(), rowsb.float(), ws)
    assert got_b.dtype == torch.bfloat16
    assert bool(((got_b.float() - want_b).abs() <= bf16_ulp(want_b)).all())

    g = torch.Generator(device="cuda").manual_seed(C + groups)
    go = torch.randn(got.shape, generator=g, device="cuda")
    grads = kernel_bwd(ref, rows, ws, go, groups)
    assert (kernel.launches, kernel_bwd.launches) == (before[0] + 2,
                                                      before[1] + 1)
    for name, a, b in zip(("d ref", "d rows", "d ws"), grads,
                          plain_bwd(ref, rows, ws, go)):
        assert a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, rtol=BWD_TOL, atol=BWD_TOL,
                                   msg=name)
    gb = go.to(torch.bfloat16)
    grads_b = kernel_bwd(rb, rowsb, ws, gb, groups)
    assert [a.dtype for a in grads_b] == [torch.float32, torch.bfloat16,
                                          torch.float32]
    for name, a, b in zip(("d ref", "d rows", "d ws"), grads_b,
                          plain_bwd(rb.float(), rowsb.float(), ws,
                                    gb.float())):
        b = b.to(a.dtype).float()
        err = (a.float() - b).abs()
        assert bool((err <= 2 * bf16_ulp(b) + BWD_TOL).all()), name


@pytest.mark.parametrize("groups", [1, 8])
def test_quad_function_matches_plain_autograd(cuda, groups):
    feats, proj, dv = _scene(16, 8, **GEOMETRIES["translation"])
    g = torch.Generator(device="cuda").manual_seed(11)
    feats = feats.requires_grad_(True)
    kernel, _, kernel_bwd, _ = _epilogues(groups)
    before = (cost_volume_cuda.launches, kernel.launches, kernel_bwd.launches)
    out = build_cost_volume(feats, proj, dv, groups, sampling="quad")
    go = torch.randn(out.shape, generator=g, device="cuda")
    got, = torch.autograd.grad(out, feats, go)
    assert (cost_volume_cuda.launches, kernel.launches,
            kernel_bwd.launches) == (before[0], before[1] + 1, before[2] + 1)
    plain = plain_quad_cost_volume(feats, proj, dv, groups)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    ref, = torch.autograd.grad(plain, feats, go)
    # index_add_ adds in a run-dependent order on the card: a rounding bound
    torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    fb = feats.detach().to(torch.bfloat16).requires_grad_(True)
    out_b = build_cost_volume(fb, proj, dv, groups, sampling="quad")
    gb, = torch.autograd.grad(out_b, fb, go.to(torch.bfloat16))
    assert out_b.dtype == gb.dtype == torch.bfloat16


def test_epilogue_kernels_reject_what_they_do_not_take(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    ref, rows, ws, _ = quad_rows(feats, proj, dv)
    with pytest.raises(ValueError, match="groups"):
        variance_epilogue_cuda(ref, rows, ws, 2)
    with pytest.raises(ValueError, match="groups"):
        groupwise_epilogue_cuda(ref, rows, ws, 1)
    with pytest.raises(ValueError, match="groups"):
        groupwise_epilogue_cuda(ref, rows, ws, 3)
    with pytest.raises(ValueError, match="ws"):
        variance_epilogue_cuda(ref, rows, ws.double())
    with pytest.raises(ValueError, match="rows"):
        variance_epilogue_cuda(ref, rows.to(torch.bfloat16), ws)
    with pytest.raises(ValueError, match="C="):
        variance_epilogue_cuda(ref[..., :4].contiguous(),
                               rows[..., :16].contiguous(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        variance_epilogue_cuda(ref, rows, ws.transpose(2, 3).contiguous()
                               .transpose(2, 3))
    with pytest.raises(ValueError, match="aligned"):
        variance_epilogue_cuda(ref, rows, torch.empty(
            ws.numel() + 1, device="cuda")[1:].view(ws.shape))
    go = torch.zeros(ref.shape[0], 8, ref.shape[1], 8, device="cuda")
    with pytest.raises(ValueError, match="grad"):
        variance_epilogue_bwd_cuda(ref, rows, ws, go.to(torch.bfloat16))
    with pytest.raises(ValueError, match="autograd"):
        variance_epilogue_cuda(ref.requires_grad_(True), rows, ws)


def _tap_inputs(C, N, seed):
    """rows (N, 4C) in [0, 1), w (N, 4) f32 with some zero weights, g (N, C)
    f32, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.rand((N, 4 * C), generator=g, device="cuda")
    w = torch.rand((N, 4), generator=g, device="cuda")
    w[torch.rand((N, 4), generator=g, device="cuda") < 0.2] = 0.0
    return rows, w, torch.randn((N, C), generator=g, device="cuda")


@pytest.mark.parametrize("N", [1, 37, 100003])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_tap_reduce_kernels_match_plain(cuda, C, N):
    """#7 and #8 against their plain versions, N no multiple of any block
    size. f32: out within 1e-5, d rows exact (one product each), d w within
    1e-5 abs + rel (another order of its sum). bf16 rows: the same bounds on
    the f32 outputs, d rows within 1 bf16 ulp of the plain one."""
    rows, w, go = _tap_inputs(C, N, C + N)
    before = tap_reduce_cuda.launches, tap_reduce_bwd_cuda.launches
    for dtype in (torch.float32, torch.bfloat16):
        r = rows.to(dtype)
        out = tap_reduce_cuda(r, w)
        assert out.shape == (N, C) and out.dtype == torch.float32
        torch.testing.assert_close(out, tr.plain_tap_reduce(r, w), rtol=0,
                                   atol=1e-5)
        d_rows, d_w = tap_reduce_bwd_cuda(r, w, go)
        p_rows, p_w = tr.plain_tap_reduce_bwd(r, w, go)
        assert d_rows.dtype == dtype and d_w.dtype == torch.float32
        if dtype == torch.float32:
            torch.testing.assert_close(d_rows, p_rows, rtol=0, atol=0)
        else:
            err = (d_rows.float() - p_rows.float()).abs()
            assert bool((err <= bf16_ulp(p_rows)).all())
        torch.testing.assert_close(d_w, p_w, rtol=1e-5, atol=1e-5)
    assert (tap_reduce_cuda.launches, tap_reduce_bwd_cuda.launches) == (
        before[0] + 2, before[1] + 2)


def test_tap_reduce_kernels_reject_what_they_do_not_take(cuda):
    rows, w, go = _tap_inputs(8, 64, 3)
    with pytest.raises(ValueError, match="C="):
        tap_reduce_cuda(rows[:, :24].contiguous(), w)
    with pytest.raises(ValueError, match="dtype"):
        tap_reduce_cuda(rows.double(), w)
    with pytest.raises(ValueError, match="w must"):
        tap_reduce_cuda(rows, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="g must"):
        tap_reduce_bwd_cuda(rows, w, go[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tap_reduce_cuda(rows, w.t().contiguous().t())
    with pytest.raises(ValueError, match="aligned"):
        tap_reduce_cuda(rows, torch.empty(w.numel() + 1,
                                          device="cuda")[1:].view(w.shape))
    with pytest.raises(ValueError, match="aligned"):
        tap_reduce_bwd_cuda(rows, w, torch.empty(
            go.numel() + 2, device="cuda")[2:].view(go.shape))
    with pytest.raises(ValueError, match="autograd"):
        tap_reduce_cuda(rows.requires_grad_(True), w)


@pytest.mark.parametrize("C", [8, 32])
def test_warp_function_matches_plain_autograd(cuda, C):
    """The packed-quad warp through #7/#8 against autograd through its plain
    route, on the same coordinates: the output within 1e-5, each leaf's
    gradient (source features, projection, depths) within relative L2
    1e-4 (index_add_ and d w sum in other orders)."""
    feats, proj, dv = _scene(C, 8, **GEOMETRIES["translation"])
    g = torch.Generator(device="cuda").manual_seed(13)
    leaves = [feats[:, 1].clone().requires_grad_(True),
              proj[:, 0].clone().requires_grad_(True),
              dv.clone().requires_grad_(True)]
    src, P, d = leaves
    before = tap_reduce_cuda.launches, tap_reduce_bwd_cuda.launches
    out = warp_src_quad_batched(pack_quad(src), P, d, 20, 36)
    go = torch.randn(out.shape, generator=g, device="cuda")
    got = torch.autograd.grad(out, leaves, go)
    assert (tap_reduce_cuda.launches, tap_reduce_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    plain = plain_grid_sample_quad(pack_quad(src),
                                   project_to_src(P, d, 20, 36), 20, 36)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    for name, a, b in zip(("d features", "d proj", "d depth"), got,
                          torch.autograd.grad(plain, leaves, go)):
        assert ((a - b).norm() / b.norm()).item() <= 1e-4, name
    out_b = warp_src_quad_batched(pack_quad(src.detach().to(torch.bfloat16)
                                            .requires_grad_(True)), P, d,
                                  20, 36)
    assert out_b.dtype == torch.bfloat16
    grads_b = torch.autograd.grad(out_b, (P, d), go.to(torch.bfloat16))
    assert all(torch.isfinite(t).all() for t in grads_b)


# --- the probe kernels, TPU kernels #9-#13 (casmvsnet_pl_tpu_torch/probes) --


@pytest.mark.parametrize("rows_per_block", [1024, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_lane_prefix_copy_matches_plain(cuda, C, dtype, rows_per_block):
    """#11 bit-exact, on a row count that is no multiple of either block."""
    g = torch.Generator(device="cuda").manual_seed(C)
    rows = torch.randn((3, 8193 + C, 4 * C), generator=g, device="cuda"
                       ).to(dtype)
    before = lane_prefix_copy_cuda.launches
    got = lane_prefix_copy_cuda(rows, rows_per_block)
    assert lane_prefix_copy_cuda.launches == before + 1
    assert torch.equal(got, epi3.plain_lane_prefix_copy(rows))


@pytest.mark.parametrize("N", [1, 37, 100003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["ldg", "cp_async", "bulk"])
def test_row_gather_forms_match_plain(cuda, form, dtype, N):
    """#13's three row-gather forms bit-exact at rows of 16 to 512 bytes,
    N no multiple of any tile; repeated indices included."""
    kernel = gather.FORMS[form]
    g = torch.Generator(device="cuda").manual_seed(N)
    for width in (8, 32, 128):
        table = torch.rand((1000, width), generator=g, device="cuda").to(dtype)
        if width * table.element_size() % 16:
            continue
        idx = torch.randint(0, 1000, (N,), generator=g, device="cuda")
        before = kernel.launches
        got = kernel(table, idx)
        assert kernel.launches == before + 1
        assert torch.equal(got, gather.plain_row_gather(table, idx))
        assert torch.equal(gather.row_gather(table, idx, form), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_gather_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(3)
    featT = torch.rand((9, 1031), generator=g, device="cuda").to(dtype)
    idx = torch.randint(0, 1031, (129,), generator=g, device="cuda")
    before = lane_gather_cuda.launches
    got = lane_gather_cuda(featT, idx)
    assert lane_gather_cuda.launches == before + 1
    assert torch.equal(got, gather.plain_lane_gather(featT, idx))


def _epilogue_rows(C, hw, seed):
    """ref, rows (two source views, D=5) and ws at hw pixels on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ref = torch.rand((2, hw, C), generator=g, device="cuda")
    rows = torch.rand((2, 2, 5, hw, 4 * C), generator=g, device="cuda")
    ws = torch.rand((2, 2, 5, hw, 4), generator=g, device="cuda")
    ws[torch.rand(ws.shape, generator=g, device="cuda") < 0.2] = 0.0
    return ref, rows, ws


@pytest.mark.parametrize("C", [8, 16, 32])
def test_variance_probes_match_plain(cuda, C):
    """#9 at dblk 1, 2 (no divisor of D=5), 4 and D, and #10 at every block
    size: f32 equal to the plain variance epilogue to 1e-5, bf16 within 1
    bf16 ulp of the plain f32 result; hw = 1003 is no multiple of a
    block."""
    ref, rows, ws = _epilogue_rows(C, 1003, C)
    plain = ce.plain_variance_epilogue(ref, rows, ws)
    rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
    plain_b = ce.plain_variance_epilogue(rb.float(), rowsb.float(), ws)
    runs = [(variance_dblk_cuda, d) for d in (1, 2, 4, 5)]
    runs += [(variance_v3_cuda, t) for t in (64, 128, 256, 512, 1024)]
    for kernel, arg in runs:
        before = kernel.launches
        torch.testing.assert_close(kernel(ref, rows, ws, arg), plain,
                                   rtol=0, atol=1e-5)
        got_b = kernel(rb, rowsb, ws, arg)
        assert kernel.launches == before + 2
        assert got_b.dtype == torch.bfloat16
        assert bool(((got_b.float() - plain_b).abs()
                     <= bf16_ulp(plain_b)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_patch_epilogue_t_matches_plain(cuda, G, dtype):
    """#12 against its plain version, f32 out within 1e-5, at Ch 8 and 12
    and hw = 1000, no multiple of the block; invalid samples (fx = -9)
    included."""
    g = torch.Generator(device="cuda").manual_seed(G)
    for Ch in (8, 12):
        rowsT = torch.randn((3, 16 * Ch, 1000), generator=g, device="cuda"
                            ).to(dtype)
        fx = torch.rand((3, G, 1000), generator=g, device="cuda") * 3.0
        fy = torch.rand((3, G, 1000), generator=g, device="cuda") * 3.0
        fx[torch.rand(fx.shape, generator=g, device="cuda") < 0.1] = -9.0
        before = patch_epilogue_t_cuda.launches
        got = patch_epilogue_t_cuda(rowsT, fx, fy)
        assert patch_epilogue_t_cuda.launches == before + 1
        assert got.shape == (3, G, Ch, 1000) and got.dtype == torch.float32
        torch.testing.assert_close(
            got, epi5.plain_patch_epilogue_t(rowsT, fx, fy), rtol=0,
            atol=1e-5)


def test_probe_kernels_reject_what_they_do_not_take(cuda):
    rows = torch.rand((64, 4 * 8), device="cuda")
    with pytest.raises(ValueError, match="16 bytes"):
        lane_prefix_copy_cuda(rows.to(torch.bfloat16)[:, :16].contiguous())
    with pytest.raises(ValueError, match="rows_per_block"):
        lane_prefix_copy_cuda(rows, 512)
    table = torch.rand((100, 8), device="cuda")
    idx = torch.arange(10, device="cuda")
    with pytest.raises(ValueError, match="int64"):
        row_gather_ldg_cuda(table, idx.int())
    with pytest.raises(ValueError, match="multiple of 16"):
        row_gather_cp_async_cuda(table[:, :3].contiguous(), idx)
    with pytest.raises(ValueError, match="tile"):
        row_gather_bulk_cuda(torch.rand((4, 4096), device="cuda"), idx[:2])
    with pytest.raises(ValueError, match="contiguous"):
        lane_gather_cuda(table.t(), idx)
    ref, rows5, ws = _epilogue_rows(8, 64, 1)
    with pytest.raises(ValueError, match="dblk"):
        variance_dblk_cuda(ref, rows5, ws, 0)
    with pytest.raises(ValueError, match="S=2"):
        variance_v3_cuda(ref, rows5[:, :1].contiguous(), ws[:, :1]
                         .contiguous())
    with pytest.raises(ValueError, match="threads"):
        variance_v3_cuda(ref, rows5, ws, 96)
    with pytest.raises(ValueError, match="autograd"):
        variance_v3_cuda(ref.requires_grad_(True), rows5, ws)
    rowsT = torch.rand((2, 128, 64), device="cuda")
    fx = torch.rand((2, 8, 64), device="cuda")
    with pytest.raises(ValueError, match="fx"):
        patch_epilogue_t_cuda(rowsT, fx[:, :3].contiguous(),
                              fx[:, :3].contiguous())
    with pytest.raises(ValueError, match="fx and fy"):
        patch_epilogue_t_cuda(rowsT, fx, fx.double())
    with pytest.raises(ValueError, match="rowsT"):
        patch_epilogue_t_cuda(rowsT[:, :100].contiguous(), fx, fx)
