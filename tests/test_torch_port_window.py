"""The window mode (``sampling="window"``) of the port against the JAX
package's window path, from ``window_config`` up to the model, the trainer
and the CLIs.

The scenes are those of tests/test_window_sampling.py (``_scene``: B=2,
V=3, 32x40, C=8, D=8), and the JAX side runs through ``conftest.bcv`` /
``bcv_grad``, which share one compile per shape and mode with that file.
The port gathers the four taps of each clamped point from the features
where JAX gathers strip rows; the clamps, weights and roundings are JAX's,
so the port is held to JAX's window output itself, also where group spans
leave the window (``span_violation``), never to the exact answer there.

Bounds: f32 outputs and feature gradients within 2e-6 abs (the JAX
suite's own); bf16 outputs within 2 bf16 ulps of JAX's bf16 window output
(they are bit-equal with JAX 0.9.0 and torch 2.13 on the CPU). The bf16
feature gradient is accumulated in float32 and cast once in the port,
where JAX's autodiff of ``jnp.take`` scatters in bf16 (a known divergence
of the two formulations, ROADMAP Queue 3): it is held within 2 bf16 ulps
of the gradient's largest value. The model within 0.05 mm on depth
(tests/test_torch_parity.py), the trainer step as
tests/test_torch_port_train_step.py holds the default route.
"""
import argparse
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval as jax_eval
import eval_torch
import train_torch
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.ops import plane_sweep as jax_ps
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import PlaneScene, read_pfm
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.ops import plane_sweep as ps
from conftest import bcv, bcv_grad
from test_torch_port_cli import _opts as cli_opts
from test_torch_port_cli import tree  # noqa: F401  (the CLI's DTU tree)
from test_torch_port_train_step import check_step_against_jax_trainer
from test_window_sampling import _scene

TOL = 2e-6
SCENES = {
    "default": {},
    "two_groups": dict(D=16),
    "out_of_image": dict(tx=9000.0, ty=-4000.0),
    "span_violation": dict(tx=900.0, ty=0.0, dmin=30.0, dint=8.0),
    "oblique": dict(tx=200.0, ty=-30.0),
    # depths from -9 to 9.6 mm: behind the camera, then far off the image
    "mixed_sign_depth": dict(dmin=-9.0),
}


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for a in arrays]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each value of ``x``."""
    return np.ldexp(np.ones_like(x), np.frexp(x)[1] - 8)


def _negative_depth():
    feats, proj, dv = _scene(np.random.RandomState(4))
    return feats, proj, dv - 500.0             # some planes behind the camera


def _case(name):
    if name == "negative_depth":
        return _negative_depth()
    return _scene(np.random.RandomState(sorted(SCENES).index(name)),
                  **SCENES[name])


@pytest.mark.parametrize("C,D", [(8, 8), (8, 32), (16, 32), (8, 12),
                                 (4, 8), (8, 16), (32, 48)])
def test_window_config_matches_jax(C, D):
    assert ps.window_config(C, D) == jax_ps.window_config(C, D)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("scene", sorted(SCENES) + ["negative_depth"])
def test_window_matches_jax(scene, groups):
    feats, proj, dv = _case(scene)
    want = np.asarray(bcv(feats, proj, dv, groups=groups, sampling="window"))
    got = ps.build_cost_volume(*_torch(feats, proj, dv), groups,
                               sampling="window")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("scene", ["default", "span_violation",
                                   "negative_depth"])
def test_window_bf16_matches_jax(scene):
    feats, proj, dv = _case(scene)
    want = np.asarray(bcv(feats.astype(jnp.bfloat16), proj, dv,
                          sampling="window")).astype(np.float32)
    f, = _torch(feats, dtype=torch.bfloat16)
    got = ps.build_cost_volume(f, *_torch(proj, dv), sampling="window")
    assert got.dtype == torch.bfloat16
    ulps = np.abs(got.float().numpy() - want) / _bf16_ulp(want)
    assert ulps.max() <= 2.0, ulps.max()


def test_span_violation_is_clamped_not_exact():
    """The violation scene's groups overflow the window, and the port
    follows JAX's clamped answer there, away from the exact one."""
    feats, proj, dv = _case("span_violation")
    tf, tp, td = _torch(feats, proj, dv)
    cfg = ps.window_config(8, 8)
    xy = ps.project_to_src(tp[:, 0], td, 32, 40)
    share = ps.window_overflow(xy, 32, 40, **cfg).float().mean().item()
    assert share > 0.1
    exact = ps.plain_cost_volume(tf, tp, td)
    window = ps.build_cost_volume(tf, tp, td, sampling="window")
    assert (window - exact).abs().max() > 1e-2
    feats, proj, dv = _case("default")
    xy = ps.project_to_src(*_torch(proj[:, 0], dv), 32, 40)
    assert not ps.window_overflow(xy, 32, 40, **cfg).any()


@pytest.mark.parametrize("scene,groups", [("default", 1), ("default", 4),
                                          ("span_violation", 1),
                                          ("negative_depth", 1)])
def test_window_gradients_match_jax(scene, groups):
    """f32 feature gradients of sum(volume^2) (the loss of
    ``conftest.bcv_grad``; groupwise through ``jax.grad`` here)."""
    feats, proj, dv = _case(scene)
    if groups == 1:
        want = np.asarray(bcv_grad(feats, proj, dv, sampling="window"))
    else:
        want = np.asarray(jax.grad(lambda f: jnp.sum(jax_ps.build_cost_volume(
            f, proj, dv, groups=groups, remat=False, sampling="window")
            ** 2))(feats))
    tf, tp, td = _torch(feats, proj, dv)
    for t in (tf, tp, td):
        t.requires_grad_(True)
    ps.build_cost_volume(tf, tp, td, groups, sampling="window"
                         ).square().sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), want, rtol=0, atol=TOL)
    assert tp.grad is None and td.grad is None


def test_window_bf16_gradient_accumulates_in_f32():
    feats, proj, dv = _case("default")
    fb = feats.astype(jnp.bfloat16)
    want = np.asarray(bcv_grad(fb, proj, dv, sampling="window")
                      ).astype(np.float32)
    f, = _torch(feats, dtype=torch.bfloat16)
    f.requires_grad_(True)
    out = ps.build_cost_volume(f, *_torch(proj, dv), sampling="window")
    out.square().sum().backward()
    assert f.grad.dtype == torch.bfloat16
    err = np.abs(f.grad.float().numpy() - want).max()
    assert err <= 2 * _bf16_ulp(np.abs(want).max()), err


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain cost volume's backward scatter-adds,
    in an order that several threads change from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fallback_is_the_exact_path(one_thread):
    """C=16 has no window config: the port's window mode is its exact
    path to the bit, and JAX's window mode (its exact samplers) agrees
    with it within the bound."""
    feats, proj, dv = _scene(np.random.RandomState(7), C=16)
    tf, tp, td = _torch(feats, proj, dv)
    tf.requires_grad_(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ps.build_cost_volume(tf, tp, td, sampling="window")
    exact = ps.build_cost_volume(tf, tp, td)
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
    g_got, = torch.autograd.grad(got.square().sum(), tf)
    g_exact, = torch.autograd.grad(exact.square().sum(), tf)
    torch.testing.assert_close(g_got, g_exact, rtol=0, atol=0)
    want = np.asarray(bcv(feats, proj, dv, sampling="window"))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="unknown"):
        ps.build_cost_volume(tf, tp, td, sampling="bogus")


def test_window_warns_once_with_jax_text():
    feats, proj, dv = _torch(*_case("default"))
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jax_ps._warn_window_once.__wrapped__()
    ps._warn_window_once.cache_clear()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for _ in range(2):
            ps.build_cost_volume(feats, proj, dv, sampling="window")
    assert [str(w.message) for w in got] == [str(want[0].message)]


N_DEPTHS, RATIOS = (8, 16, 16), (1.0, 2.0, 4.0)


def test_window_model_matches_jax_window_model():
    """The cascade with sampling="window" (the window at level 0, C=8;
    levels 1 and 2 exact) at 64x64 against the JAX model's."""
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS,
                          sampling="window")
    init_weights(model, torch.Generator().manual_seed(5))
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean += torch.from_numpy(
                    rng.randn(*m.running_mean.shape).astype(np.float32) * 0.05)
                m.running_var *= torch.from_numpy(1 + 0.1 * rng.rand(
                    *m.running_var.shape).astype(np.float32))
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
                    sampling="window")
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


def test_window_train_step_matches_jax_trainer():
    check_step_against_jax_trainer("window")


def _sampling_action(module, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, argv=None: self)
        parser = module.get_opts([])
    return next(a for a in parser._actions if a.dest == "sampling")


@pytest.mark.parametrize("window", ["", "1"])
def test_eval_flags_match_eval_py(monkeypatch, window):
    monkeypatch.setenv("CASMVS_ENABLE_WINDOW_SAMPLING", window)
    port = _sampling_action(eval_torch, monkeypatch)
    want = _sampling_action(jax_eval, monkeypatch)
    assert port.choices == want.choices and port.default == want.default
    assert ("window" in port.choices) == (window == "1")


def test_cli_window_runs_on_cpu(tree, tmp_path, monkeypatch,  # noqa: F811
                               one_thread):
    """``train_torch.py --sampling window`` one epoch and ``eval_torch.py
    --sampling window`` on the CLI tests' tree, under
    CASMVS_ENABLE_WINDOW_SAMPLING=1."""
    root, Tiny = tree
    monkeypatch.setenv("CASMVS_ENABLE_WINDOW_SAMPLING", "1")
    monkeypatch.chdir(tmp_path)
    trainer, state = train_torch.main(
        cli_opts(root, "--num_epochs", "1", "--exp_name", "w",
                 "--sampling", "window"), Tiny, time_steps=True)
    assert state.model.sampling == "window" and state.step == 5
    assert all(np.isfinite(t["loss"]) for t in trainer.step_times)

    args = eval_torch.get_opts([
        "--cpu", "--root_dir", root, "--split", "train", "--scan",
        "synth1", "--n_views", "3", "--img_wh", "32", "32",
        "--n_depths", "8", "8", "8", "--precision", "f32",
        "--ckpt_path", "ckpts/w/last.ckpt", "--sampling", "window"])
    ds = Tiny(root, "train", n_views=3, img_wh=(32, 32))
    ds.metas = [m for m in ds.metas if m[0] == "synth1"][:1]
    eval_torch.run_inference(args, ds, ["synth1"])
    scan, _, vid = ds.metas[0][:3]
    depth = read_pfm(f"results/dtu/depth/{scan}/depth_{vid:04d}.pfm")[0]
    assert depth.shape == (32, 32) and np.isfinite(depth).all()
