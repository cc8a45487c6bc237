"""K2's plain version (``plain_cost_volume_bwd``) and the port's autograd
through the cost volume, against ``jax.vjp`` of the JAX ``build_cost_volume``.

On the CPU the JAX patch sampler's backward runs kernel #2's plain
reference (``kernels/patch_epilogue.py::_tfma_bwd``), as the JAX suite runs
it, and the quad sampler its XLA scatter. The bound is 1e-5 (rtol and atol),
the bound of the port's cost-volume tests: looser than the JAX suite's 2e-6
between its own two samplers (tests/test_patch_sampling.py), because the
port adds the taps' shares in another order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.ops.plane_sweep import build_cost_volume as jax_bcv
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (build_cost_volume,
                                                    plain_cost_volume,
                                                    plain_cost_volume_bwd)
from test_torch_port_cuda import GEOMETRIES


def _scene(rng, C, D, tx, ty, dmin, dint, B=2, V=3, H=12, W=16):
    feats = rng.rand(B, V, H, W, C).astype(np.float32)
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32),
                   (B, V - 1, 1, 1))
    proj[..., 0, 3] = tx
    proj[..., 1, 3] = ty
    proj[1, :, :3, :3] += rng.randn(V - 1, 3, 3).astype(np.float32) * 0.01
    dv = ((dmin + dint * np.arange(D, dtype=np.float32))[None, :, None, None]
          * np.ones((B, D, H, W), np.float32))
    return feats, proj, dv


@functools.partial(jax.jit, static_argnames=("groups", "sampling"))
def _jax_vjp(feats, proj, dv, cot, groups, sampling):
    _, vjp = jax.vjp(lambda f: jax_bcv(f, proj, dv, groups=groups,
                                       remat=False, sampling=sampling), feats)
    return vjp(cot)[0]


@pytest.mark.parametrize("sampling", ["patch", "quad"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_bwd_matches_jax_grad(C, groups, sampling):
    rng = np.random.RandomState(C + 3 * groups)
    D = 8
    for name, geo in GEOMETRIES.items():
        feats, proj, dv = _scene(rng, C, D, **geo)
        B, V, H, W, _ = feats.shape
        cot = rng.randn(B, D, H, W, C if groups == 1 else groups
                        ).astype(np.float32)
        ref = np.asarray(_jax_vjp(jnp.asarray(feats), jnp.asarray(proj),
                                  jnp.asarray(dv), jnp.asarray(cot),
                                  groups=groups, sampling=sampling))
        tf, tp, td, tc = (torch.from_numpy(a) for a in (feats, proj, dv, cot))
        got = plain_cost_volume_bwd(tf, tp, td, tc, groups).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        # autograd through the dispatcher (the CPU path) gives the same
        tf.requires_grad_(True)
        auto, = torch.autograd.grad(build_cost_volume(tf, tp, td, groups),
                                    tf, tc)
        np.testing.assert_allclose(auto.numpy(), ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_plain_bwd_equals_autograd_of_plain_forward(groups):
    rng = np.random.RandomState(20 + groups)
    for name, geo in GEOMETRIES.items():
        feats, proj, dv = (torch.from_numpy(a)
                           for a in _scene(rng, 16, 8, **geo))
        out = plain_cost_volume(feats, proj, dv, groups)
        cot = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
        feats.requires_grad_(True)
        auto, = torch.autograd.grad(plain_cost_volume(feats, proj, dv, groups),
                                    feats, cot)
        got = plain_cost_volume_bwd(feats.detach(), proj, dv, cot, groups)
        torch.testing.assert_close(got, auto, rtol=0, atol=1e-6, msg=name)


def test_coordinates_get_no_gradient():
    rng = np.random.RandomState(30)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 8, 8, **GEOMETRIES["translation"]))
    for t in (feats, proj, dv):
        t.requires_grad_(True)
    plain_cost_volume(feats, proj, dv).sum().backward()
    assert feats.grad is not None and feats.grad.abs().sum() > 0
    assert proj.grad is None and dv.grad is None


def test_bwd_is_adjoint_of_fwd():
    """Groupwise is bilinear in (ref, sources): with the reference view
    fixed, <fwd(f), g> = <f_src, bwd(g)_src>, and with the sources fixed
    <fwd(f), g> = <f_ref, bwd(g)_ref>. Variance is a quadratic form, so
    <f, bwd(g)> = 2 <fwd(f), g> (Euler)."""
    rng = np.random.RandomState(31)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 16, 8, **GEOMETRIES["translation"]))
    for groups in (1, 4):
        out = plain_cost_volume(feats, proj, dv, groups)
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
        lhs = torch.vdot(out.double().flatten(), g.double().flatten())
        grad = plain_cost_volume_bwd(feats, proj, dv, g, groups).double()
        f = feats.double()
        if groups == 1:
            rhs = torch.vdot(f.flatten(), grad.flatten()) / 2
            torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0)
        else:
            for part in (slice(0, 1), slice(1, None)):
                rhs = torch.vdot(f[:, part].flatten(),
                                 grad[:, part].flatten())
                torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0)

