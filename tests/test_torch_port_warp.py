"""The port's packed-quad warp (``grid_sample_quad``,
``warp_src_quad_batched``) and the rest of the JAX ``ops`` API
(``warp_src_feature``,
``variance_cost_volume``, ``groupwise_cost_volume``) against the JAX
package's functions.

On the CPU ``grid_sample_quad`` runs its autograd Function with the plain
weighted 4-tap reduce (``ops/tap_reduce.py``, the plain versions of TPU
kernels #7/#8); the JAX function runs its XLA row gather and lane-slice
combine. Bounds: 1e-5 per op in float32, as the port's other sampler tests.
The warp's projection rounds differently from JAX's by about 1e-5 px, so
the warp is held at 1e-4, the coordinates' gradient only on coordinates
kept 1e-3 px from any integer (a floor that lands in another cell moves
it), and the projection's VJP on its own, where it is smooth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.ops import groupwise_cost_volume as jax_gw_cv
from casmvsnet_pl_tpu.ops import project_to_src as jax_project
from casmvsnet_pl_tpu.ops import variance_cost_volume as jax_var_cv
from casmvsnet_pl_tpu.ops import warp_src_feature as jax_warp_feature
from casmvsnet_pl_tpu.ops.grid_sample import grid_sample_quad as jax_gsq
from casmvsnet_pl_tpu.ops.grid_sample import pack_quad as jax_pack_quad
from casmvsnet_pl_tpu.ops.plane_sweep import \
    warp_src_quad_batched as jax_warp_quad
from casmvsnet_pl_tpu_torch.ops import (groupwise_cost_volume,
                                        grid_sample_quad, pack_quad,
                                        plain_grid_sample_quad,
                                        project_to_src, quad_weights,
                                        variance_cost_volume,
                                        warp_src_feature,
                                        warp_src_quad_batched)
from test_torch_port_cost_volume_bwd import _scene
from test_torch_port_cuda import GEOMETRIES

TOL = dict(rtol=1e-5, atol=1e-5)
WARP_TOL = dict(rtol=1e-4, atol=1e-4)
H, W, C = 13, 17, 8


def coord_mix(rng, n=2000):
    """tests/test_grid_sample.py's mix: in and out of bounds, the (W, H)
    behind-camera sentinel, far outside, exact corners."""
    return np.concatenate([
        rng.uniform(-3, [W + 3, H + 3], size=(n, 2)),
        np.array([[W, H]] * 4),
        rng.uniform(-1e4, 1e4, size=(50, 2)),
        np.array([[0, 0], [W - 1, H - 1], [-1, -1], [W - 0.5, H - 0.5]]),
    ]).astype(np.float32)


def off_integer(rng, n=2000):
    """In and out of bounds and far outside, each coordinate at least 1e-3
    px from an integer (and so from a jump of the floor)."""
    whole = np.concatenate([rng.randint(-3, [W + 3, H + 3], size=(n, 2)),
                            rng.randint(-10000, 10000, size=(50, 2))])
    return (whole + rng.uniform(1e-3, 1 - 1e-3, whole.shape)).astype(
        np.float32)


def bf16_ulp(x):
    """Spacing of bf16 numbers at x (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float64))[1] - 8)


@pytest.mark.parametrize("batched", [False, True])
def test_grid_sample_quad_matches_jax(batched):
    rng = np.random.RandomState(4 + batched)
    B = 2 if batched else None
    lead = (B,) if batched else ()
    feat = rng.randn(*lead, H, W, C).astype(np.float32)
    xy = np.stack([coord_mix(rng) for _ in range(B)]) if batched else \
        coord_mix(rng)
    jq = (jax.vmap(jax_pack_quad) if batched else jax_pack_quad)(
        jnp.asarray(feat))
    want = np.asarray(jax_gsq(jq, jnp.asarray(xy), H, W))
    got = grid_sample_quad(pack_quad(torch.from_numpy(feat)),
                           torch.from_numpy(xy), H, W)
    assert got.shape == want.shape == xy.shape[:-1] + (C,)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _jax_grads(table, xy, cot):
    out, vjp = jax.vjp(lambda t, p: jax_gsq(t, p, H, W), jnp.asarray(table),
                       jnp.asarray(xy))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]


def _port_grads(table, xy, cot, fn=grid_sample_quad):
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(xy).requires_grad_(True)
    out = fn(t, p, H, W)
    d_t, d_p = torch.autograd.grad(out, (t, p), torch.from_numpy(cot))
    return [a.detach().numpy() for a in (out, d_t, d_p)]


def test_grid_sample_quad_gradients_match_jax():
    rng = np.random.RandomState(6)
    table = np.array(jax_pack_quad(jnp.asarray(
        rng.randn(H, W, C).astype(np.float32))))
    # the table's gradient on the whole mix
    xy = coord_mix(rng)
    cot = rng.randn(xy.shape[0], C).astype(np.float32)
    _, want_t, _ = _jax_grads(table, xy, cot)
    _, got_t, _ = _port_grads(table, xy, cot)
    np.testing.assert_allclose(got_t, want_t, err_msg="d table", **TOL)
    # the coordinates' gradient away from the floor's jumps
    xy = off_integer(rng)
    cot = rng.randn(xy.shape[0], C).astype(np.float32)
    want = _jax_grads(table, xy, cot)
    got = _port_grads(table, xy, cot)
    for name, a, b in zip(("out", "d table"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    d_xy, want_xy = got[2], want[2]
    assert np.abs(want_xy).max() > 0
    rel = np.linalg.norm(d_xy - want_xy) / np.linalg.norm(want_xy)
    assert rel <= 1e-4, f"d xy relative L2 {rel}"
    # autograd through the plain route gives the Function's gradients
    plain = _port_grads(table, xy, cot, plain_grid_sample_quad)
    for name, a, b in zip(("out", "d table", "d xy"), got, plain):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_grid_sample_quad_bf16():
    """bf16 table: the port sums in f32 and rounds once, so it is within 1
    bf16 ulp of JAX's f32 result on the same bf16 values; JAX's bf16
    function rounds the tap weights and every partial sum, so the two bf16
    results differ by up to 2^-6 sum_q |w_q r_q| + 1 ulp."""
    rng = np.random.RandomState(7)
    feat = jnp.asarray(rng.randn(H, W, C).astype(np.float32), jnp.bfloat16)
    table = jax_pack_quad(feat)
    xy = coord_mix(rng)
    want_f32 = np.asarray(jax_gsq(table.astype(jnp.float32), jnp.asarray(xy),
                                  H, W))
    want_bf16 = np.asarray(jax_gsq(table, jnp.asarray(xy), H, W)
                           .astype(jnp.float32))
    t_table = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        torch.bfloat16)
    got = grid_sample_quad(t_table, torch.from_numpy(xy), H, W)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want_f32) <= bf16_ulp(want_f32))
    w4, y0i, x0i = quad_weights(torch.from_numpy(xy), H, W)
    rows = t_table.float()[y0i, x0i].reshape(-1, 4, C)
    mag = (rows * w4[..., None]).abs().sum(1).numpy()
    assert np.all(np.abs(got - want_bf16)
                  <= 2.0 ** -6 * mag + bf16_ulp(want_bf16))
    # its gradients come back in the table's dtype, f32 for the coordinates
    t = t_table.requires_grad_(True)
    p = torch.from_numpy(off_integer(rng)).requires_grad_(True)
    out = grid_sample_quad(t, p, H, W)
    d_t, d_p = torch.autograd.grad(out, (t, p), torch.ones_like(out))
    assert d_t.dtype == torch.bfloat16 and d_p.dtype == torch.float32
    assert torch.isfinite(d_t.float()).all() and torch.isfinite(d_p).all()


@jax.jit
def _jax_warp(feats, proj, dv, cot):
    """JAX warp of source view 1 through its pack_quad table, and its VJP
    in the source features."""
    Hs, Ws = feats.shape[2:4]

    def f(src):
        return jax_warp_quad(jax.vmap(jax_pack_quad)(src), proj[:, 0], dv,
                             Hs, Ws)
    out, vjp = jax.vjp(f, feats[:, 1])
    return out, vjp(cot)[0]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_warp_src_quad_batched_matches_jax(geometry):
    rng = np.random.RandomState(len(geometry))
    feats, proj, dv = _scene(rng, 16, 8, **GEOMETRIES[geometry])
    B, V, Hs, Ws, Cs = feats.shape
    cot = rng.randn(B, 8, Hs, Ws, Cs).astype(np.float32)
    want, want_grad = (np.asarray(a) for a in _jax_warp(
        *(jnp.asarray(a) for a in (feats, proj, dv, cot))))
    src = torch.from_numpy(feats[:, 1]).requires_grad_(True)
    tp = torch.from_numpy(proj[:, 0]).requires_grad_(True)
    td = torch.from_numpy(dv).requires_grad_(True)
    out = warp_src_quad_batched(pack_quad(src), tp, td, Hs, Ws)
    assert out.shape == want.shape == (B, 8, Hs, Ws, Cs)
    np.testing.assert_allclose(out.detach().numpy(), want, **WARP_TOL)
    tc = torch.from_numpy(cot)
    grads = torch.autograd.grad(out, (src, tp, td), tc)
    np.testing.assert_allclose(grads[0].numpy(), want_grad,
                               err_msg="d features", **WARP_TOL)
    # the gradient reaches the projection and the depths, and equals
    # autograd through the plain route
    xy = project_to_src(tp, td, Hs, Ws)
    plain = plain_grid_sample_quad(pack_quad(src), xy, Hs, Ws)
    for name, a, b in zip(("d features", "d proj", "d depth"), grads,
                          torch.autograd.grad(plain, (src, tp, td), tc)):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, msg=name, **TOL)
    if geometry == "translation":
        assert grads[1].abs().sum() > 0 and grads[2].abs().sum() > 0


def _depth_terms(proj, dv, cot):
    """Per depth sample, in float64, the size of the two terms whose
    difference is d xy / d depth: with n = rot * d + T and r = 1 / n_z,
    dx/dd = rot_x r - n_x rot_z r^2 (and y alike), weighted by |cot|."""
    B, D, Hs, Ws = dv.shape
    ys, xs = np.meshgrid(np.arange(Hs), np.arange(Ws), indexing="ij")
    P = proj.astype(np.float64)[:, :, None, None, None, :]   # (B, 3, .., 4)
    d = dv.astype(np.float64)
    rot = P[..., 0] * xs + P[..., 1] * ys + P[..., 2]        # (B, 3, 1, H, W)
    n = rot * d[:, None] + P[..., 3]
    r = 1.0 / n[:, 2]
    size = sum(np.abs(cot[..., k]) * (np.abs(rot[:, k] * r)
                                      + np.abs(n[:, k] * rot[:, 2] * r * r))
               for k in range(2))
    return np.where(n[:, 2] <= 1e-7 * d, 0.0, size)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_project_to_src_vjp_matches_jax(geometry):
    """1e-5 relative L2. d depth on the translation rig is the difference
    of two terms ~200x its size, so both packages' f32 VJPs sit ~1e-5 from
    the exact one there; it is held at 1e-5 of those terms' size."""
    rng = np.random.RandomState(20 + len(geometry))
    _, proj, dv = _scene(rng, 8, 8, **GEOMETRIES[geometry])
    Hs, Ws = dv.shape[2:]
    proj = proj[:, 0]
    cot = rng.randn(*dv.shape, 2).astype(np.float32)
    out, vjp = jax.vjp(jax.vmap(lambda p, d: jax_project(p, d, Hs, Ws)),
                       jnp.asarray(proj), jnp.asarray(dv))
    want = [np.asarray(a) for a in vjp(jnp.asarray(cot))]
    tp = torch.from_numpy(proj).requires_grad_(True)
    td = torch.from_numpy(dv).requires_grad_(True)
    got = torch.autograd.grad(project_to_src(tp, td, Hs, Ws), (tp, td),
                              torch.from_numpy(cot))
    scales = (want[0], _depth_terms(proj, dv, cot))
    for name, a, b, s in zip(("d proj", "d depth"), got, want, scales):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        assert np.linalg.norm(s) >= np.linalg.norm(b) > 0, name
        rel = np.linalg.norm(a - b) / np.linalg.norm(s)
        assert rel <= 1e-5, f"{name} relative L2 {rel}"


def test_single_sample_ops_match_jax():
    """warp_src_feature, variance_cost_volume and groupwise_cost_volume
    (G=8) of one sample, each against its JAX counterpart."""
    rng = np.random.RandomState(30)
    feats, proj, dv = _scene(rng, 16, 8, **GEOMETRIES["translation"])
    f, p, d = feats[1], proj[1], dv[1]              # one sample, rotated rig
    tf, tp, td = (torch.from_numpy(a) for a in (f, p, d))
    got = warp_src_feature(tf[1], tp[0], td)
    want = jax_warp_feature(jnp.asarray(f[1]), jnp.asarray(p[0]),
                            jnp.asarray(d))
    assert got.shape == want.shape == (8, 12, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = variance_cost_volume(tf, tp, td)
    want = jax_var_cv(jnp.asarray(f), jnp.asarray(p), jnp.asarray(d))
    assert got.shape == want.shape == (8, 12, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = groupwise_cost_volume(tf, tp, td, 8)
    want = jax_gw_cv(jnp.asarray(f), jnp.asarray(p), jnp.asarray(d), 8)
    assert got.shape == want.shape == (8, 12, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
