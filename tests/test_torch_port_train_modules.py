"""The port's modules in train mode against the JAX package's.

Train mode normalizes with the batch statistics and moves the running
statistics towards them. flax updates the running variance with the biased
batch variance; torch's own BatchNorm with the unbiased one (n / (n - 1)),
which the port's ``models/blocks.py`` repairs. The JAX modules run with
``train=True, mutable=["batch_stats"]``; both sides start from the same
weights and perturbed running statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.models import FeatureNet as JaxFeatureNet
from casmvsnet_pl_tpu.models.blocks import ConvBnAct as JaxConvBnAct
from casmvsnet_pl_tpu.models.blocks import \
    ConvTransposeBnAct3D as JaxConvTransposeBnAct3D
from casmvsnet_pl_tpu.models.cost_reg import CostRegNet as JaxCostRegNet
from casmvsnet_pl_tpu.models.cost_reg import CostRegNetFolded
from casmvsnet_pl_tpu_torch.models import CostRegNet, FeatureNet
from casmvsnet_pl_tpu_torch.models.blocks import (ConvBnAct,
                                                  ConvTransposeBnAct3D)
from casmvsnet_pl_tpu_torch.utils import state_dict_from_jax
from test_torch_port_model import perturb_stats

STATS_TOL = 1e-5
OUT_TOL = 1e-4
GRAD_TOL = 1e-4


def _jax_train(module, var, stats, x):
    with jax.default_matmul_precision("float32"):
        out, mutated = jax.jit(
            lambda v, s, x: module.apply({"params": v, "batch_stats": s}, x,
                                         train=True,
                                         mutable=["batch_stats"]))(
            var["params"], stats, jnp.asarray(x))
    return out, mutated["batch_stats"]


def _assert_stats_match(net, params, new_stats, prefix="", tol=STATS_TOL):
    ref = state_dict_from_jax(params, new_stats)
    got = net.state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k[len(prefix):]].numpy(),
                                   ref[k].numpy(), atol=tol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("block", ["conv", "deconv"])
def test_bn_running_var_is_biased_as_flax(block):
    """One train-mode forward at 32 values per channel: the running var
    must move towards the biased batch variance, as flax's does. Torch's
    own BatchNorm gives var * 32/31 there (a gap of ~3e-3 after one step);
    the bound is 1e-6."""
    rng = np.random.RandomState(7)
    if block == "conv":
        x = rng.randn(1, 2, 4, 4, 4).astype(np.float32)   # (B, D, H, W, C)
        jm = JaxConvBnAct(6, dims=3)
        name, prefix = None, ""
    else:
        x = rng.randn(1, 1, 2, 2, 4).astype(np.float32)   # doubles to 2x4x4
        jm = JaxConvTransposeBnAct3D(6)
        name, prefix = "deconv7", "conv7."
    var = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    stats = perturb_stats(var["batch_stats"], 8)
    out, new_stats = _jax_train(jm, var, stats, x)
    if name:   # state_dict_from_jax names a deconv by its parent's slot
        params, stats, new_stats = ({name: t} for t in
                                    (var["params"], stats, new_stats))
    else:
        params = var["params"]
    net = ConvBnAct(4, 6, dims=3) if block == "conv" \
        else ConvTransposeBnAct3D(4, 6)
    sd = {k[len(prefix):]: v for k, v in
          state_dict_from_jax(params, stats).items()}
    net.load_state_dict(sd, strict=True)
    net.train()
    got = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(out), atol=1e-5, rtol=0)
    _assert_stats_match(net, params, new_stats, prefix, tol=1e-6)
    assert int(net.state_dict()[
        "bn.num_batches_tracked" if block == "conv"
        else "1.num_batches_tracked"]) == 1


def test_bn_train_mode_keeps_f32_statistics_under_bf16_input():
    net = ConvBnAct(3, 8, dims=2).train()
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = net(x)
    assert y.dtype == torch.bfloat16
    assert net.bn.running_var.dtype == torch.float32
    assert net.bn.weight.dtype == torch.float32


def test_feature_net_train_mode_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jf = JaxFeatureNet()
    var = jax.jit(jf.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    stats = perturb_stats(var["batch_stats"], 13)
    ref, new_stats = _jax_train(jf, var, stats, x)
    net = FeatureNet().train()
    net.load_state_dict(state_dict_from_jax(var["params"], stats),
                        strict=True)
    got = net(torch.from_numpy(x))
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=OUT_TOL, rtol=0,
                                   err_msg=k)
    _assert_stats_match(net, var["params"], new_stats)


@pytest.mark.parametrize("jax_net", [JaxCostRegNet, CostRegNetFolded])
def test_cost_reg_train_mode_matches_jax(jax_net):
    """The JAX cascade trains its D <= 32 levels with the folded net, so
    the port's one CostRegNet is held against both."""
    rng = np.random.RandomState(14)
    x = rng.randn(2, 8, 16, 16, 8).astype(np.float32)
    var = jax.jit(JaxCostRegNet().init)(jax.random.PRNGKey(5),
                                        jnp.asarray(x))
    stats = perturb_stats(var["batch_stats"], 15)
    ref, new_stats = _jax_train(jax_net(), var, stats, x)
    net = CostRegNet(8).train()
    net.load_state_dict(state_dict_from_jax(var["params"], stats),
                        strict=True)
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=OUT_TOL, rtol=0)
    _assert_stats_match(net, var["params"], new_stats)


def _train_grad_errors(jmodule, var, net, x, seed):
    """Relative L2 error of the port's train-mode gradients of
    <net(x), ct> (a seeded random cotangent), per parameter leaf and for x,
    against JAX's."""
    def f(params, x):
        out, _ = jmodule.apply({"params": params,
                                "batch_stats": var["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return out

    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(jax.jit(f), var["params"], jnp.asarray(x))
        rng = np.random.RandomState(seed)
        cts = jax.tree_util.tree_map(
            lambda o: rng.randn(*o.shape).astype(np.float32), out)
        jp, jx = jax.device_get(vjp(jax.tree_util.tree_map(jnp.asarray,
                                                           cts)))
    want = state_dict_from_jax(jp, var["batch_stats"])
    want["input"] = torch.from_numpy(np.array(jx))

    xt = torch.from_numpy(x).requires_grad_()
    got = net(xt)
    if isinstance(got, dict):
        got, cts = zip(*((got[k], cts[k]) for k in sorted(got)))
    else:
        got, cts = (got,), (cts,)
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(got, [*params.values(), xt],
                                [torch.from_numpy(c) for c in cts])
    errs = {}
    for name, g in zip([*params, "input"], grads):
        w = want[name].double()
        errs[name] = ((g.double() - w).norm() / w.norm()).item()
    return errs


def test_feature_net_train_mode_gradients_match_jax():
    rng = np.random.RandomState(16)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jf = JaxFeatureNet()
    var = jax.jit(jf.init)(jax.random.PRNGKey(6), jnp.asarray(x))
    net = FeatureNet().train()
    net.load_state_dict(state_dict_from_jax(var["params"],
                                            var["batch_stats"]), strict=True)
    errs = _train_grad_errors(jf, var, net, x, seed=17)
    assert len(errs) == len(list(net.parameters())) + 1
    bad = {k: e for k, e in errs.items() if not e < GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("jax_net", [JaxCostRegNet, CostRegNetFolded])
def test_cost_reg_train_mode_gradients_match_jax(jax_net):
    rng = np.random.RandomState(18)
    x = rng.randn(2, 8, 16, 16, 8).astype(np.float32)
    var = jax.jit(JaxCostRegNet().init)(jax.random.PRNGKey(7),
                                        jnp.asarray(x))
    net = CostRegNet(8).train()
    net.load_state_dict(state_dict_from_jax(var["params"],
                                            var["batch_stats"]), strict=True)
    errs = _train_grad_errors(jax_net(), var, net, x, seed=19)
    assert len(errs) == len(list(net.parameters())) + 1
    bad = {k: e for k, e in errs.items() if not e < GRAD_TOL}
    assert not bad, bad
