"""The port against the JAX package at the eval configuration's shapes, on
the CPU: five views, a non-square image (96x64), B=2 with a depth range per
sample; variance, groupwise G=4, and G=8 with ``sampling="quad"``.

These are the shapes whose edges K1's lanes, depth blocks and tiles must
handle on the card (``tests/test_torch_port_cuda.py`` holds K1 against the
plain version there); here the plain version is held against JAX.
Tolerances are the suite's: 1e-5 abs on a cost volume, 0.05 mm on depth,
1e-4 on confidence (measured: 1.2e-5). Weights go through ``utils/convert.py``'s counterpart
in the JAX package, inputs come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import bcv as _bcv
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.ops.plane_sweep import build_cost_volume

V, B, IMG_WH = 5, 2, (96, 64)
DMIN = np.array([425.0, 440.0], np.float32)    # a depth range per sample
DINT = np.array([2.65, 5.3], np.float32)
# (groups, sampling of the port, sampling of the JAX package)
CONFIGS = {"variance": (1, "auto", "patch"), "g4": (4, "auto", "patch"),
           "g8_quad": (8, "quad", "quad")}


def _scene():
    """(imgs (B, V, 64, 96, 3), proj (B, V-1, 3, 3, 4)): the plane scene's
    five views, the second sample's rotations perturbed."""
    scene = PlaneScene(img_wh=IMG_WH, n_views=V, z0=460.0, baseline=12.0,
                       focal=120.0, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    rng = np.random.RandomState(7)
    imgs = np.concatenate([imgs, imgs[:, ::-1]])
    proj = np.concatenate([proj, proj])
    proj[1, ..., :3] += rng.randn(V - 1, 3, 3, 3).astype(np.float32) * 1e-3
    return imgs, proj


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("C,D", [(8, 8), (32, 8)])
def test_cost_volume_matches_jax(config, C, D):
    groups, sampling, jax_sampling = CONFIGS[config]
    rng = np.random.RandomState(C + D + groups)
    W, H = IMG_WH
    feats = rng.rand(B, V, H, W, C).astype(np.float32)
    _, proj = _scene()
    proj = np.ascontiguousarray(proj[:, :, 0])            # full resolution
    dv = ((DMIN[:, None] + DINT[:, None] * np.arange(D, dtype=np.float32))
          [:, :, None, None] * np.ones((B, D, H, W), np.float32))
    ref = np.asarray(_bcv(jnp.asarray(feats), jnp.asarray(proj),
                          jnp.asarray(dv), groups=groups,
                          sampling=jax_sampling))
    got = build_cost_volume(torch.from_numpy(feats), torch.from_numpy(proj),
                            torch.from_numpy(dv), groups,
                            sampling=sampling).numpy()
    assert got.shape == ref.shape == (B, D, H, W, C if groups == 1
                                      else groups)
    assert np.ptp(ref) > 0, "degenerate volume"
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cascade_matches_jax(config):
    groups, sampling, jax_sampling = CONFIGS[config]
    n_depths, ratios = (8, 8, 16), (1.0, 2.0, 4.0)
    model = CascadeMVSNet(n_depths=n_depths, interval_ratios=ratios,
                          num_groups=groups, sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(groups))
    with torch.no_grad():
        # sharpen the softmax over depth so the depths spread over the sweep
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    model.eval()
    imgs, proj = _scene()

    params, stats, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    jm = JaxCascade(n_depths=n_depths, interval_ratios=ratios,
                    num_groups=groups, sampling=jax_sampling)
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                                jnp.asarray(imgs), jnp.asarray(proj),
                                jnp.asarray(DMIN), jnp.asarray(DINT))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(proj),
                    torch.from_numpy(DMIN), torch.from_numpy(DINT))

    W, H = IMG_WH
    for lvl in range(3):
        rd = np.asarray(ref[f"depth_{lvl}"])
        gd = got[f"depth_{lvl}"].numpy()
        assert gd.shape == rd.shape == (B, H >> lvl, W >> lvl)
        assert np.ptp(rd) > 1.0, "degenerate depth map"
        err = np.abs(gd - rd).max()
        assert err < 5e-2, f"depth_{lvl} max err {err} mm"
        cerr = np.abs(got[f"confidence_{lvl}"].numpy()
                      - np.asarray(ref[f"confidence_{lvl}"])).max()
        assert cerr < 1e-4, f"confidence_{lvl} max err {cerr}"
