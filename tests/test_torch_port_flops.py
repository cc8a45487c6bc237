"""The port's FLOP count (``utils/flops.py``) and its timer
(``utils/profiling.py::device_time``) on the CPU.

The convolutions that ``FlopCounterMode`` counts over one forward equal the
count from the layer shapes alone; the feature net's count equals the
convolutions of the JAX ``FeatureNet``'s jaxpr (2 x output elements x
kernel taps x Cin per group over its ``conv_general_dilated`` equations);
the cost volume's count is its formula; the card's peak is looked up by
name and never guessed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from casmvsnet_pl_tpu.models import FeatureNet as JaxFeatureNet
from casmvsnet_pl_tpu_torch.entry import DEPTH_INTERVAL, DEPTH_MIN, entry
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet, FeatureNet
from casmvsnet_pl_tpu_torch.utils import flops
from casmvsnet_pl_tpu_torch.utils import profiling

# the convolutions of one forward of the default model at B=1
CONV_64x96x3 = 1_837_891_584
CONV_640x512x3 = 98_020_884_480
CONV_1152x864x5 = 331_977_719_808
MODULES_640x512x3 = {"feature": 16_908_288_000, "cost_reg_2": 19_959_644_160,
                     "cost_reg_1": 35_106_324_480,
                     "cost_reg_0": 26_046_627_840}


@pytest.mark.parametrize("batch", [1, 2])
def test_counted_convolutions_equal_the_analytic_count(batch):
    _, (model, imgs, proj) = entry("cpu", batch=batch, img_wh=(96, 64))
    counted = flops.conv_flops(model, imgs, proj, DEPTH_MIN, DEPTH_INTERVAL)
    assert counted == flops.analytic_conv_flops(model, (96, 64), 3, batch)
    assert sorted(counted) == ["cost_reg_0", "cost_reg_1", "cost_reg_2",
                               "feature"]
    assert sum(counted.values()) == batch * CONV_64x96x3


@pytest.mark.parametrize("img_wh,n_views,want", [
    ((640, 512), 3, CONV_640x512x3), ((1152, 864), 5, CONV_1152x864x5)])
def test_analytic_count_runs_no_forward(monkeypatch, img_wh, n_views, want):
    """The bench and eval shapes, from the layer shapes alone: a forward
    would raise."""
    def no_forward(*a, **k):
        raise AssertionError("a forward ran")

    model = CascadeMVSNet()
    for m in model.modules():
        monkeypatch.setattr(m, "forward", no_forward)
    got = flops.analytic_conv_flops(model, img_wh, n_views, 1)
    assert sum(got.values()) == want
    if img_wh == (640, 512):
        assert got == MODULES_640x512x3
    assert flops.forward_flops(model, img_wh, n_views, 1) == {
        "conv": want,
        "cost_volume": flops.cost_volume_flops((8, 32, 48), (8, 16, 32),
                                               img_wh, n_views, 1),
        "total": want + flops.cost_volume_flops((8, 32, 48), (8, 16, 32),
                                                img_wh, n_views, 1)}


def test_analytic_count_names_an_unknown_convolution():
    model = CascadeMVSNet()
    model.feature.extra = torch.nn.Conv2d(8, 8, 3)
    with pytest.raises(ValueError, match="'extra' of FeatureNet"):
        flops.analytic_conv_flops(model, (96, 64), 3, 1)


def _jaxpr_conv_flops(jaxpr) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            dn = eqn.params["dimension_numbers"]
            rhs = eqn.invars[1].aval.shape
            taps = math.prod(rhs[d] for d in dn.rhs_spec[2:])
            total += (2 * math.prod(eqn.outvars[0].aval.shape) * taps
                      * rhs[dn.rhs_spec[1]])
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += _jaxpr_conv_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += _jaxpr_conv_flops(sub)
    return total


@pytest.mark.parametrize("n,H,W", [(3, 64, 96), (2, 128, 160)])
def test_feature_net_count_equals_the_jax_jaxpr(n, H, W):
    net = JaxFeatureNet()
    x = jnp.zeros((n, H, W, 3), jnp.float32)
    variables = net.init(jax.random.PRNGKey(0), x)
    jaxpr = jax.make_jaxpr(lambda v, x: net.apply(v, x))(variables, x)
    want = _jaxpr_conv_flops(jaxpr.jaxpr)
    port = FeatureNet()
    counted = flops.counted_conv_flops(port, port, torch.rand(n, H, W, 3))
    assert sum(counted.values()) == want
    if (n, H, W) == (3, 64, 96):
        assert want == 317_030_400
    model = CascadeMVSNet()
    assert flops.analytic_conv_flops(model, (W, H), n, 1)["feature"] == want


@pytest.mark.parametrize("groups", [1, 8])
def test_cost_volume_flops_is_its_formula(groups):
    B, V, img_wh = 2, 3, (96, 64)
    want = want_bwd = 0
    for D, C, h, w in ((8, 8, 64, 96), (32, 16, 32, 48), (48, 32, 16, 24)):
        S = V - 1
        combine = 3 * C * S + 4 * C if groups == 1 else 2 * C * S + C
        per = S * (29 + 8 * C) + combine
        want += B * D * h * w * per
        want_bwd += B * D * h * w * (per + 8 * C * S)
    assert flops.cost_volume_flops((8, 32, 48), (8, 16, 32), img_wh, V, B,
                                   groups) == want
    assert flops.cost_volume_flops((8, 32, 48), (8, 16, 32), img_wh, V, B,
                                   groups, backward=True) == want_bwd


def test_peak_flops_of_the_h100_sxm():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", torch.float32) == 67e12


@pytest.mark.parametrize("device", ["NVIDIA A100-SXM4-80GB", "cpu",
                                    torch.device("cpu")])
def test_peak_flops_raises_rather_than_guess(device):
    with pytest.raises(ValueError, match="no published"):
        flops.peak_flops(device)


@pytest.mark.parametrize("iters,warmup", [(16, 2), (3, 0), (1, 5)])
def test_device_time_on_cpu_calls_warmup_plus_iters(iters, warmup):
    calls = []
    x = torch.ones(4)

    def fn(t):
        calls.append(t)
        return t * 2

    dt = profiling.device_time(fn, x, iters=iters, warmup=warmup)
    assert len(calls) == warmup + iters
    assert all(c is x for c in calls)
    assert dt > 0 and math.isfinite(dt)


def test_device_time_verbose_prints_min_median_max(capsys):
    dev, host = profiling.call_times(lambda: sum(range(1000)), iters=5)
    assert dev == host and len(dev) == 5 and min(dev) > 0
    dt = profiling.device_time(lambda: sum(range(1000)), iters=5,
                               verbose=True)
    out = capsys.readouterr().out
    assert "device ms min/median/max" in out and "host ms" in out
    assert dt > 0


def test_device_time_finds_the_card_in_its_arguments():
    """The arguments decide between CUDA events and the host's clock: CPU
    tensors, alone or in dicts, lists and tuples, take the clock."""
    args = (torch.ones(2), {"a": [torch.ones(1)], "b": (torch.ones(1),)},
            torch.nn.Linear(2, 2), 3.0, "x")
    assert not profiling._on_card(args)
    assert not profiling._on_card((torch.empty(2, device="meta"),))


def test_measurement_device_never_falls_back_to_the_cpu(monkeypatch):
    assert profiling.measurement_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.measurement_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.measurement_device("cuda:0")


def test_probes_share_the_cost_volume_formula():
    """The kernels' bounds in chip_smoke.py count K1's operations as this
    module does."""
    from casmvsnet_pl_tpu_torch.probes.common import cv_work

    for groups in (1, 8):
        _, ops = cv_work(1, 3, 48, 16, 24, 32, groups, 2)
        assert ops == flops.cost_volume_flops((48,), (32,), (24, 16), 3, 1,
                                              groups)
        _, ops = cv_work(2, 3, 8, 64, 96, 8, groups, 2, backward=True)
        assert ops == flops.cost_volume_flops(
            (8,), (8,), (96, 64), 3, 2, groups, backward=True)
    assert np.isclose(flops.PEAK_FLOPS["NVIDIA H100 80GB HBM3"][
        torch.float32], 67e12)
