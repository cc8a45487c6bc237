"""The port's schedules, optimizers, loss and metrics against the JAX
package's (optax; ``casmvsnet_pl_tpu/losses.py`` and ``metrics.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from casmvsnet_pl_tpu import losses as jax_losses
from casmvsnet_pl_tpu import metrics as jax_metrics
from casmvsnet_pl_tpu.utils import OptimConfig as JaxOptimConfig
from casmvsnet_pl_tpu.utils import make_lr_schedule as jax_schedule
from casmvsnet_pl_tpu.utils import make_optimizer as jax_make_optimizer
from casmvsnet_pl_tpu.utils import wrap_params_for
from casmvsnet_pl_tpu_torch import losses, metrics
from casmvsnet_pl_tpu_torch.utils import (Lookahead, OptimConfig,
                                          make_lr_schedule, make_optimizer)
from casmvsnet_pl_tpu_torch.utils.optimizers import set_lr

SCHEDULES = {
    "steplr": dict(lr=1.0, lr_scheduler="steplr", decay_step=(2, 4),
                   decay_gamma=0.1),
    "cosine": dict(lr=1e-3, lr_scheduler="cosine", num_epochs=16),
    "poly": dict(lr=1.0, lr_scheduler="poly", num_epochs=10, poly_exp=0.9),
    "warmup_steplr": dict(lr=1.0, optimizer="adam", lr_scheduler="steplr",
                          decay_step=(6,), warmup_multiplier=10.0,
                          warmup_epochs=2),
    "warmup_cosine": dict(lr=1e-3, optimizer="sgd", lr_scheduler="cosine",
                          num_epochs=8, warmup_multiplier=4.0,
                          warmup_epochs=3),
    "no_warmup_radam": dict(lr=1e-3, optimizer="radam",
                            lr_scheduler="cosine", num_epochs=8,
                            warmup_multiplier=4.0, warmup_epochs=3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """Within 1e-6 of the base lr: the JAX schedule runs in float32, the
    port's in float64."""
    kw = SCHEDULES[name]
    spe = 7
    ref = jax_schedule(JaxOptimConfig(**kw), spe)
    got = make_lr_schedule(OptimConfig(**kw), spe)
    for step in [0, 1, 3, 6, 7, 13, 14, 20, 21, 27, 35, 41, 56, 69, 70, 77,
                 84, 111, 112, 140, 200]:
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=0,
                                   atol=1e-6 * kw["lr"],
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("name", ["sgd", "adam", "radam", "ranger"])
def test_optimizer_matches_optax(name):
    """7 steps on the quadratic of tests/test_optim_ckpt.py, with a cosine
    schedule and L2 weight decay: RAdam rectifies from step 6, and ranger's
    Lookahead syncs after step 6."""
    kw = dict(optimizer=name, lr=1e-2, weight_decay=1e-2,
              lr_scheduler="cosine", num_epochs=3)
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 4).astype(np.float32)
    b0 = rng.randn(4).astype(np.float32)

    jcfg = JaxOptimConfig(**kw)
    tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=2)
    params = wrap_params_for(jcfg, {"w": jnp.asarray(w0), "b": jnp.asarray(b0)})
    opt_state = tx.init(params)

    def loss(p):
        return jnp.sum(p["w"] ** 2) + jnp.sum(p["b"] ** 2) \
            + jnp.sum(p["w"] * p["b"])

    w = torch.tensor(w0, requires_grad=True)
    b = torch.tensor(b0, requires_grad=True)
    opt, sched = make_optimizer(OptimConfig(**kw), 2, [w, b])
    for step in range(7):
        fast = params.fast if name == "ranger" else params
        updates, opt_state = tx.update(jax.grad(loss)(fast), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)

        set_lr(opt, sched(step))
        opt.zero_grad()
        ((w ** 2).sum() + (b ** 2).sum() + (w * b).sum()).backward()
        opt.step()
        fast = params.fast if name == "ranger" else params
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(fast["w"]),
                                   rtol=1e-6, atol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(fast["b"]),
                                   rtol=1e-6, atol=1e-6, err_msg=str(step))
        if name == "ranger":
            assert isinstance(opt, Lookahead)
            slow_w, slow_b = opt.slow_params()
            np.testing.assert_allclose(slow_w.numpy(),
                                       np.asarray(params.slow["w"]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(slow_b.numpy(),
                                       np.asarray(params.slow["b"]),
                                       rtol=1e-6, atol=1e-6)
    if name == "ranger":   # the sync after step 6 moved the slow weights
        assert not np.allclose(opt.slow_params()[0].numpy(), w0)


def _depth_inputs(seed, empty_level=None):
    rng = np.random.RandomState(seed)
    shapes = {0: (2, 16, 16), 1: (2, 8, 8), 2: (2, 4, 4)}
    results, depths, masks = {}, {}, {}
    for l, s in shapes.items():
        gt = rng.uniform(400, 500, s).astype(np.float32)
        # errors from well inside to well outside SL1's |d| < 1 branch
        results[f"depth_{l}"] = gt + rng.randn(*s).astype(np.float32) * 3
        depths[f"level_{l}"] = gt
        masks[f"level_{l}"] = rng.rand(*s) > 0.3
        if l == empty_level:
            masks[f"level_{l}"][:] = False
    return results, depths, masks


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("empty_level", [None, 1])
def test_loss_matches_jax(empty_level):
    r, d, m = _depth_inputs(1, empty_level)
    ref = float(jax_losses.sl1_loss(_jax(r), _jax(d), _jax(m)))
    got = losses.sl1_loss(_torch(r), _torch(d), _torch(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    # the gradient with respect to every level's prediction
    ref_grads = jax.grad(lambda r: jax_losses.sl1_loss(r, _jax(d), _jax(m)))(
        _jax(r))
    preds = {k: v.requires_grad_() for k, v in _torch(r).items()}
    grads = torch.autograd.grad(losses.sl1_loss(preds, _torch(d), _torch(m)),
                                list(preds.values()))
    for k, g in zip(preds, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    assert losses.loss_dict["sl1"] is losses.sl1_loss
    empty = torch.zeros(2, 4, 4, dtype=torch.bool)
    assert float(losses.masked_mean(torch.ones(2, 4, 4), empty)) == 0.0


@pytest.mark.parametrize("empty", [False, True])
def test_metrics_match_jax(empty):
    r, d, m = _depth_inputs(2, 0 if empty else None)
    pred, gt, mask = r["depth_0"], d["level_0"], m["level_0"]
    tp, tg, tm = (torch.from_numpy(a) for a in (pred, gt, mask))
    jp, jg, jm = (jnp.asarray(a) for a in (pred, gt, mask))
    np.testing.assert_allclose(metrics.abs_error(tp, tg, tm).numpy(),
                               np.asarray(jax_metrics.abs_error(jp, jg, jm)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics.abs_error_mean(tp, tg, tm)),
                               float(jax_metrics.abs_error_mean(jp, jg, jm)),
                               rtol=1e-6)
    for t in (1.0, 2.0, 4.0):
        np.testing.assert_allclose(
            float(metrics.acc_threshold_mean(tp, tg, tm, t)),
            float(jax_metrics.acc_threshold_mean(jp, jg, jm, t)), rtol=1e-6)
    got = metrics.metric_sums(tp, tg, tm)
    ref = jax_metrics.metric_sums(jp, jg, jm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
