"""The quad configuration (``sampling="quad"``) of the port against the JAX
package's packed-quad sampler, from the pack helpers up to the whole model.

On the CPU the port's quad route runs its autograd Function with the plain
cost epilogues (``ops/cost_epilogue.py``); the JAX ``build_cost_volume(
sampling="quad")`` runs its XLA row gather, ``_tap_reduce`` and the
float32 scatter of ``_quad_sample_bwd``. Bounds: 1e-5 per op, as the
port's other cost-volume tests; 0.05 mm on depth and 1e-2 on confidence
for the model, as tests/test_torch_port_cascade.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.ops.grid_sample import pack_quad as jax_pack_quad
from casmvsnet_pl_tpu.ops.grid_sample import quad_weights as jax_quad_weights
from casmvsnet_pl_tpu.ops.plane_sweep import build_cost_volume as jax_bcv
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.entry import init_weights, train_entry
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.ops import (build_cost_volume, pack_quad,
                                        pack_quad_adjoint,
                                        plain_cost_volume,
                                        plain_quad_cost_volume,
                                        quad_cost_volume, quad_weights)
from test_torch_port_cost_volume_bwd import _scene
from test_torch_port_cuda import GEOMETRIES

TOL = dict(rtol=1e-5, atol=1e-5)


def test_pack_quad_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 3, 5, 7, 8).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(jax_pack_quad))(jnp.asarray(feat)))
    got = pack_quad(torch.from_numpy(feat))
    assert got.shape == (2, 3, 6, 8, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quad_weights_match_jax():
    rng = np.random.RandomState(1)
    H, W = 13, 17
    xy = np.concatenate([
        rng.uniform(-3, [W + 3, H + 3], size=(2000, 2)),
        np.array([[W, H]] * 4),                    # behind-camera sentinel
        rng.uniform(-1e4, 1e4, size=(50, 2)),      # far outside
        np.array([[0, 0], [W - 1, H - 1], [-1, -1], [-0.5, 3.0],
                  [W - 0.5, H - 0.5], [W - 1, -0.25], [-0.999, -0.999]]),
    ]).astype(np.float32)
    w_want, y_want, x_want = (np.asarray(a) for a in
                              jax_quad_weights(jnp.asarray(xy), H, W))
    w, y0i, x0i = quad_weights(torch.from_numpy(xy), H, W)
    assert w.dtype == torch.float32 and y0i.dtype == x0i.dtype == torch.int64
    np.testing.assert_array_equal(w.numpy(), w_want)
    np.testing.assert_array_equal(y0i.numpy(), y_want)
    np.testing.assert_array_equal(x0i.numpy(), x_want)


def test_pack_quad_adjoint_is_the_adjoint():
    """<pack(f), g> = <f, adjoint(g)> in float64."""
    rng = np.random.RandomState(2)
    f = torch.from_numpy(rng.randn(2, 6, 9, 4))
    g = torch.from_numpy(rng.randn(2, 7, 10, 16))
    lhs = torch.vdot(pack_quad(f).flatten(), g.flatten())
    rhs = torch.vdot(f.flatten(), pack_quad_adjoint(g).flatten())
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=0)


@functools.partial(jax.jit, static_argnames=("groups",))
def _jax_quad(feats, proj, dv, cot, groups):
    out, vjp = jax.vjp(lambda f: jax_bcv(f, proj, dv, groups=groups,
                                         remat=False, sampling="quad"), feats)
    return out, vjp(cot)[0]


@pytest.mark.parametrize("C,groups", [(8, 1), (16, 1), (32, 1), (8, 8),
                                      (16, 2), (16, 4), (32, 8)])
def test_quad_route_matches_jax(C, groups):
    """Forward and gradient of the quad route against JAX's and the port's
    default route, at every geometry (one far off the image: border)."""
    rng = np.random.RandomState(C + groups)
    D = 8
    for name, geo in GEOMETRIES.items():
        feats, proj, dv = _scene(rng, C, D, **geo)
        B, V, H, W, _ = feats.shape
        cot = rng.randn(B, D, H, W, C if groups == 1 else groups
                        ).astype(np.float32)
        want, want_grad = (np.asarray(a) for a in _jax_quad(
            *(jnp.asarray(a) for a in (feats, proj, dv, cot)), groups=groups))
        tf, tp, td, tc = (torch.from_numpy(a) for a in (feats, proj, dv, cot))
        tf.requires_grad_(True)
        out = quad_cost_volume(tf, tp, td, groups)
        grad, = torch.autograd.grad(out, tf, tc)
        assert out.shape == want.shape, name
        np.testing.assert_allclose(out.detach().numpy(), want, err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(grad.numpy(), want_grad, err_msg=name,
                                   **TOL)
        # the dispatcher gives the same, and so does autograd through the
        # plain route (the gather's own backward in place of index_add_)
        out2 = build_cost_volume(tf, tp, td, groups, sampling="quad")
        grad2, = torch.autograd.grad(out2, tf, tc)
        torch.testing.assert_close(out2, out, rtol=0, atol=0)
        torch.testing.assert_close(grad2, grad, rtol=0, atol=0)
        out3 = plain_quad_cost_volume(tf, tp, td, groups)
        grad3, = torch.autograd.grad(out3, tf, tc)
        torch.testing.assert_close(out3, out, rtol=0, atol=0)
        torch.testing.assert_close(grad3, grad, **TOL)
        # both routes are exact bilinear: they agree with the default one
        out4 = plain_cost_volume(tf, tp, td, groups)
        grad4, = torch.autograd.grad(out4, tf, tc)
        torch.testing.assert_close(out, out4, **TOL)
        torch.testing.assert_close(grad, grad4, **TOL)


def test_quad_route_coordinates_get_no_gradient():
    rng = np.random.RandomState(3)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 8, 8, **GEOMETRIES["translation"]))
    for t in (feats, proj, dv):
        t.requires_grad_(True)
    quad_cost_volume(feats, proj, dv).sum().backward()
    assert feats.grad is not None and feats.grad.abs().sum() > 0
    assert proj.grad is None and dv.grad is None


def test_window_sampling_is_refused():
    """An unknown sampling mode is refused; the window mode is known
    (tests/test_torch_port_window.py holds it against JAX)."""
    rng = np.random.RandomState(4)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 8, 8, **GEOMETRIES["translation"]))
    out = build_cost_volume(feats, proj, dv, sampling="window")
    assert out.shape == (2, 8, 12, 16, 8)
    with pytest.raises(ValueError, match="unknown"):
        build_cost_volume(feats, proj, dv, sampling="bilinear")


N_DEPTHS, RATIOS = (8, 16, 16), (1.0, 2.0, 4.0)


@pytest.mark.parametrize("num_groups", [1, 8])
def test_quad_model_matches_jax_quad_model(num_groups):
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS,
                          num_groups=num_groups, sampling="quad")
    init_weights(model, torch.Generator().manual_seed(num_groups))
    rng = np.random.RandomState(num_groups)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean += torch.from_numpy(
                    rng.randn(*m.running_mean.shape).astype(np.float32) * 0.05)
                m.running_var *= torch.from_numpy(
                    1 + 0.1 * rng.rand(*m.running_var.shape).astype(np.float32))
        # sharpen the softmax over depth so the depths spread over the sweep
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    model.eval()
    scene = PlaneScene(img_wh=(64, 64), n_views=3, z0=460.0, baseline=12.0,
                       focal=120.0, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    dmin = np.array([425.0], np.float32)
    dint = np.array([2.65], np.float32)

    params, stats, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    jm = JaxCascade(n_depths=N_DEPTHS, interval_ratios=RATIOS,
                    num_groups=num_groups, sampling="quad")
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                                jnp.asarray(imgs), jnp.asarray(proj),
                                jnp.asarray(dmin), jnp.asarray(dint))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(proj),
                    torch.from_numpy(dmin), torch.from_numpy(dint))
    for lvl in range(3):
        rd = np.asarray(ref[f"depth_{lvl}"])
        gd = got[f"depth_{lvl}"].numpy()
        assert gd.shape == rd.shape == (1, 64 >> lvl, 64 >> lvl)
        assert np.ptp(rd) > 1.0, "degenerate depth map"
        err = np.abs(gd - rd).max()
        assert err < 5e-2, f"depth_{lvl} max err {err} mm"
        cerr = np.abs(got[f"confidence_{lvl}"].numpy()
                      - np.asarray(ref[f"confidence_{lvl}"])).max()
        assert cerr < 1e-2, f"confidence_{lvl} max err {cerr}"


def test_quad_train_step_matches_default_route():
    """One f32 SGD step with sampling="quad" against the default route from
    the same weights and batch; updates bounded as in
    tests/test_torch_port_train_step.py."""
    runs = []
    for sampling in ("auto", "quad"):
        trainer, state, batch = train_entry(
            "cpu", img_wh=(64, 64), n_depths=(8, 8, 8), optimizer="sgd",
            lr=1e-2, optim_kwargs=dict(momentum=0.0, weight_decay=0.0),
            sampling=sampling)
        start = {k: v.detach().clone().double()
                 for k, v in state.model.named_parameters()}
        state, logs = trainer.train_step(state, batch)
        runs.append((float(logs["train/loss"]),
                     {k: v.detach().double() - start[k]
                      for k, v in state.model.named_parameters()}))
    (la, ua), (lq, uq) = runs
    assert abs(lq - la) <= 1e-6 * abs(la), (lq, la)
    for k in ua:
        scale = ua[k.replace("prob.bias", "prob.weight")].norm()
        err = ((uq[k] - ua[k]).norm() / scale).item()
        assert err < 0.1, f"{k}: update relative L2 {err:.2e}"
    da = torch.cat([u.flatten() for u in ua.values()])
    dq = torch.cat([u.flatten() for u in uq.values()])
    assert ((dq - da).norm() / da.norm()).item() < 1e-2
