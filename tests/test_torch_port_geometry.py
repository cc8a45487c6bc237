"""The port's geometry ops against the JAX package's, on seeded inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from casmvsnet_pl_tpu.ops import geometry as jg
from casmvsnet_pl_tpu_torch.ops import geometry as tg


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", ["random", "behind_camera"])
def test_project_to_src(case):
    rng = np.random.RandomState(0)
    H, W, D = 6, 9, 4
    if case == "random":
        proj = rng.randn(3, 4).astype(np.float32)
        depths = ((rng.rand(D, H, W) + 0.5) * 100).astype(np.float32)
    else:
        # a source camera rotated half a turn about y: every plane in
        # front of the reference lies behind it -> (W, H)
        proj = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
        proj = np.hstack([proj, rng.randn(3, 1).astype(np.float32)])
        depths = np.full((D, H, W), 50.0, np.float32)
    ref = np.asarray(jg.project_to_src(jnp.asarray(proj), jnp.asarray(depths),
                                       H, W))
    got = tg.project_to_src(_t(proj), _t(depths), H, W).numpy()
    assert got.shape == (D, H, W, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    if case == "behind_camera":
        assert np.all(got[..., 0] == W) and np.all(got[..., 1] == H)
    # the port also takes a leading batch axis
    got_b = tg.project_to_src(_t(np.stack([proj, proj])),
                              _t(np.stack([depths, depths])), H, W).numpy()
    np.testing.assert_array_equal(got_b[1], got)


@pytest.mark.parametrize("interval", [2.5, "per_sample"])
def test_get_depth_values_with_clamp(interval):
    rng = np.random.RandomState(1)
    B, D, H, W = 2, 8, 5, 7
    cur = (rng.rand(B, H, W) * 40).astype(np.float32)   # some clamp at 1e-7
    iv = np.float32(2.5) if interval == 2.5 else \
        np.array([2.5, 4.0], np.float32)
    ref = np.asarray(jg.get_depth_values(jnp.asarray(cur), D, jnp.asarray(iv)))
    got = tg.get_depth_values(_t(cur), D, _t(iv)).numpy()
    assert got.shape == (B, D, H, W)
    assert np.any(ref[:, 0] == np.float32(1e-7))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("per_sample", [False, True])
def test_initial_depth_values(per_sample):
    B, D, H, W = 2, 8, 3, 4
    dmin = np.array([425.0, 300.0], np.float32) if per_sample else 425.0
    dint = np.array([2.65, 5.0], np.float32) if per_sample else 2.65
    ref = np.asarray(jg.initial_depth_values(dmin, dint, D, B, H, W))
    got = tg.initial_depth_values(
        _t(dmin) if per_sample else dmin, _t(dint) if per_sample else dint,
        D, B, H, W)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("flat_depths", [False, True])
def test_depth_regression(flat_depths):
    rng = np.random.RandomState(2)
    B, D, H, W = 2, 8, 5, 6
    logits = rng.randn(B, D, H, W).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dv = (425.0 + 2.65 * np.arange(D, dtype=np.float32)) if flat_depths else \
        (400.0 + 100 * rng.rand(B, D, H, W)).astype(np.float32)
    ref = np.asarray(jg.depth_regression(jnp.asarray(prob), jnp.asarray(dv)))
    got = tg.depth_regression(_t(prob), _t(dv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("op", ["resize", "upsample2x"])
def test_bilinear_resize_align_corners(op):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 3, 5, 7, 4).astype(np.float32)
    if op == "resize":
        ref = np.asarray(jg.resize_bilinear(jnp.asarray(x), (9, 13)))
        got = tg.resize_bilinear(_t(x), (9, 13)).numpy()
    else:
        ref = np.asarray(jg.upsample2x(jnp.asarray(x)))
        got = tg.upsample2x(_t(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_pixel_grid():
    np.testing.assert_array_equal(tg.pixel_grid(3, 4).numpy(),
                                  np.asarray(jg.pixel_grid(3, 4)))
