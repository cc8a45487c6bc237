"""The port's modules against the JAX package's, on converted weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.models import FeatureNet as JaxFeatureNet
from casmvsnet_pl_tpu.models.cost_reg import CostRegNet as JaxCostRegNet
from casmvsnet_pl_tpu.models.cost_reg import CostRegNetFolded
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet, CostRegNet, FeatureNet
from casmvsnet_pl_tpu_torch.utils import state_dict_from_jax


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def perturb_stats(stats, seed):
    """Nontrivial BN running statistics, as tests/test_torch_parity.py."""
    rng = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = np.asarray(v) + rng.randn(*v.shape).astype(
                    np.float32) * 0.05
            else:
                out[k] = np.asarray(v) * (1 + 0.1 * rng.rand(*v.shape)
                                          ).astype(np.float32)
        return out
    return walk(stats)


def test_state_dict_round_trip():
    rng = np.random.RandomState(0)
    imgs = jnp.asarray(rng.randn(1, 3, 32, 32, 3).astype(np.float32))
    proj = jnp.asarray(np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]),
                               (1, 2, 3, 1, 1)).astype(np.float32))
    jm = JaxCascade(n_depths=(8, 8, 8))
    var = jax.jit(jm.init)(jax.random.PRNGKey(0), imgs, proj, 425.0, 2.65)
    params = jax.tree.map(np.asarray, var["params"])
    stats = perturb_stats(var["batch_stats"], 1)

    sd = state_dict_from_jax(params, stats)
    model = CascadeMVSNet(n_depths=(8, 8, 8))
    model.load_state_dict(sd, strict=True)

    back_p, back_s, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    for orig, back in ((_flat(params), _flat(back_p)),
                       (_flat(stats), _flat(back_s))):
        assert orig.keys() == back.keys()
        for k in orig:
            np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_feature_net_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jf = JaxFeatureNet()
    var = jax.jit(jf.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    stats = perturb_stats(var["batch_stats"], 3)
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(jf.apply)({"params": var["params"],
                                 "batch_stats": stats}, jnp.asarray(x))
    net = FeatureNet().eval()
    net.load_state_dict(state_dict_from_jax(var["params"], stats),
                        strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("jax_net", [JaxCostRegNet, CostRegNetFolded])
def test_cost_reg_matches_jax(jax_net):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 8, 16, 16, 8).astype(np.float32)
    # the two JAX nets share one parameter tree: init once, apply either
    var = jax.jit(JaxCostRegNet().init)(jax.random.PRNGKey(2), jnp.asarray(x))
    stats = perturb_stats(var["batch_stats"], 5)
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(jax_net().apply)(
            {"params": var["params"], "batch_stats": stats}, jnp.asarray(x))
    net = CostRegNet(8).eval()
    net.load_state_dict(state_dict_from_jax(var["params"], stats),
                        strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (1, 8, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
