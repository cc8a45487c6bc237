"""The port's cascade forward against the JAX package's, as a whole.

The port's model gets seeded weights and perturbed BN statistics; its state
dict goes through ``convert_state_dict`` into the JAX model. Tolerances are
those of tests/test_torch_parity.py: 0.05 mm on depth, 1e-2 on confidence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet

N_DEPTHS, RATIOS = (8, 16, 16), (1.0, 2.0, 4.0)


@pytest.mark.parametrize("num_groups", [1, 4])
def test_cascade_matches_jax(num_groups):
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS,
                          num_groups=num_groups)
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
                    num_groups=num_groups)
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
