"""The port's plain sampler and cost volume against the JAX package's.

On the CPU the JAX patch sampler runs kernel #1's plain reference
(``kernels/patch_epilogue.py::_tfma_fwd``), as the JAX suite itself runs it,
and the quad sampler its XLA gathers; the port runs its plain version.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import bcv as _bcv
from casmvsnet_pl_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda
from casmvsnet_pl_tpu_torch.ops.grid_sample import grid_sample
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (build_cost_volume,
                                                    plain_cost_volume)

# The geometries of tests/test_patch_sampling.py: translation-only (fits the
# patch groups), an absurd baseline (falls back to quad), and planes behind
# the source camera.
GEOMETRIES = {
    "translation": dict(tx=40.0, ty=12.0, dmin=430.0, dint=2.65),
    "absurd_baseline": dict(tx=900.0, ty=0.0, dmin=30.0, dint=8.0),
    "negative_depth": dict(tx=40.0, ty=12.0, dmin=-9.0, dint=2.65),
}


def _scene(rng, C, D, tx, ty, dmin, dint, B=1, V=3, H=12, W=16):
    feats = rng.rand(B, V, H, W, C).astype(np.float32)
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32),
                   (B, V - 1, 1, 1))
    proj[..., 0, 3] = tx
    proj[..., 1, 3] = ty
    dv = ((dmin + dint * np.arange(D, dtype=np.float32))[None, :, None, None]
          * np.ones((B, D, H, W), np.float32))
    return feats, proj, dv


def test_plain_sampler_matches_jax_grid_sample():
    rng = np.random.RandomState(4)
    H, W, C = 13, 17, 8
    feat = rng.randn(H, W, C).astype(np.float32)
    xy = np.concatenate([
        rng.uniform(-3, [W + 3, H + 3], size=(2000, 2)),
        np.array([[W, H]] * 4),                    # behind-camera sentinel
        rng.uniform(-1e4, 1e4, size=(50, 2)),      # far outside
        np.array([[0, 0], [W - 1, H - 1], [-1, -1], [-0.5, 3.0],
                  [W - 0.5, H - 0.5], [W - 1, -0.25], [-0.999, -0.999]]),
    ]).astype(np.float32)
    ref = np.asarray(jax_grid_sample(jnp.asarray(feat), jnp.asarray(xy)))
    got = grid_sample(torch.from_numpy(feat), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_plain_sampler_border_keeps_in_image_share():
    feat = torch.ones(4, 4, 1)
    xy = torch.tensor([[-0.5, 1.0], [1.0, -0.5], [3.5, 1.0], [1.0, 3.5]])
    np.testing.assert_allclose(grid_sample(feat, xy)[:, 0].numpy(),
                               [0.5, 0.5, 0.5, 0.5], atol=1e-6)


@pytest.mark.parametrize("sampling", ["patch", "quad"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("C,D", [(8, 8), (8, 16), (16, 8), (16, 16),
                                 (32, 8), (32, 16)])
def test_cost_volume_matches_jax(C, D, groups, sampling):
    rng = np.random.RandomState(C + D + groups)
    for name, geo in GEOMETRIES.items():
        feats, proj, dv = _scene(rng, C, D, **geo)
        ref = np.asarray(_bcv(jnp.asarray(feats), jnp.asarray(proj),
                              jnp.asarray(dv), groups=groups,
                              sampling=sampling))
        got = build_cost_volume(torch.from_numpy(feats),
                                torch.from_numpy(proj), torch.from_numpy(dv),
                                groups).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=name)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(5)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 8, 8, **GEOMETRIES["translation"]))
    before = cost_volume_cuda.launches
    got = build_cost_volume(feats, proj, dv)
    assert cost_volume_cuda.launches == before == 0
    torch.testing.assert_close(got, plain_cost_volume(feats, proj, dv),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_cuda(feats, proj, dv)


def test_plain_cost_volume_bf16_is_rounded_f32():
    rng = np.random.RandomState(6)
    feats, proj, dv = (torch.from_numpy(a) for a in
                       _scene(rng, 16, 8, **GEOMETRIES["translation"]))
    fb = feats.to(torch.bfloat16)
    got = plain_cost_volume(fb, proj, dv, groups=4)
    assert got.dtype == torch.bfloat16
    ref = plain_cost_volume(fb.float(), proj, dv, groups=4)
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)
