"""One train-step gradient of the port against ``jax.grad`` of the JAX
model, both in float64: the port's trainer at ``dtype=torch.float64`` and
the JAX ``CascadeMVSNet(dtype=jnp.float64)`` under ``jax.enable_x64``,
from the same weights (the default config, n_depths 8/32/48, seeded) on
two plane scenes at B=2, for ``sampling="auto"`` and ``"window"``.

What float64 can and cannot pin. Both packages keep the same pieces in
float32 by design (the projection, the cost volume's sums, the softmax
over depth, the depth regression, the loss), so the two gradients agree to
the rounding of those pieces, carried through the step, and not to
float64's. The step carries rounding far: each ReLU whose input sits
within rounding of 0 switches its mask. Measured with JAX 0.9.0 and
torch 2.13 on the CPU: at 64x64 the port's float64 gradient moves by
4.0-4.3e-4 (relative L2 over all leaves) when the images are scaled by
1 + 1e-7, the JAX gradient sits 1.1e-4 from it, and the port's
all-float32 step 9.4e-3; at 160x128 (window), 1.7e-4, 2.0e-4 and 5.7e-4.
So the bound is relative to the step's own sensitivity, measured in the
same test: the gap to JAX within SENSITIVITY_FACTOR times the gradient's
move under that 1e-7 rescale. A fault (a missing term, a wrong
weight) moves the gradient by O(1).

The JAX side runs its exact fallback samplers: its patch sampler and
banded scatter (``patch_config``, ``banded_cfg``) stop with mixed int32 /
int64 indices under x64 past 64x64, so both are declined here and the
JAX package takes its quad/block paths with plain XLA scatters, the same
bilinear semantics. The window mode at level 0 is JAX's own.

Every case is in the slow tier: at 64x64 a case takes ~90 s on 8
threads, most of it the JAX compile; at 640x512 (D = 48/32/8, B = 2, the
reference training shape) the JAX side needs ~50 GB of host memory (4.1 GB
at 160x128, growing with the pixels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.losses import sl1_loss as jax_sl1_loss
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.ops import plane_sweep as jax_ps
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import PlaneScene, collate
from casmvsnet_pl_tpu_torch.engine import MVSTrainer
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import OptimConfig, state_dict_from_jax

SENSITIVITY_FACTOR = 3.0
RESCALE = 1e-7


def _batch(img_wh):
    """Two plane scenes with the rig of ``probes/common.py::plane_levels``
    (the focal length scaled with the width)."""
    W, _ = img_wh
    samples = []
    for i in range(2):
        scene = PlaneScene(img_wh=img_wh, n_views=3, z0=460.0 + 8.0 * i,
                           baseline=12.0, focal=600.0 * W / 640,
                           slope_x=0.05 * (i - 4), seed=i)
        imgs, proj, depths = scene.model_inputs()
        samples.append({
            "imgs": imgs[0], "proj_mats": proj[0],
            "init_depth_min": np.float32(425.0),
            "depth_interval": np.float32(2.65),
            "depths": {k: v[0] for k, v in depths.items()},
            "masks": {k: np.ones(v[0].shape, bool)
                      for k, v in depths.items()}})
    return collate(samples)


def _model(sampling):
    model = CascadeMVSNet(sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _port_gradient(sampling, batch, rescale=1.0):
    """The port trainer's float64 gradient of one SGD step: {name:
    array}, and the step's loss."""
    batch = dict(batch, imgs=batch["imgs"] * rescale)
    trainer = MVSTrainer(_model(sampling), OptimConfig(
        optimizer="sgd", lr=1e-2, momentum=0.0, weight_decay=0.0),
        steps_per_epoch=10, device="cpu", dtype=torch.float64)
    state = trainer.init_state()
    state, logs = trainer.train_step(state, trainer.device_batch(batch))
    return ({n: p.grad.double().numpy()
             for n, p in state.model.named_parameters()},
            float(logs["train/loss"]))


def _jax_gradient(sampling, batch):
    """``jax.grad`` of the JAX model's train-mode loss in float64, in the
    port's parameter names, and the loss."""
    params, stats, skipped = convert_state_dict(_model(sampling).state_dict())
    assert skipped == []
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)

        model = JaxCascade(dtype=jnp.float64, sampling=sampling)
        stats64 = f64(stats)
        depths = f64(batch["depths"])
        masks = {k: jnp.asarray(v) for k, v in batch["masks"].items()}

        def loss_fn(p):
            outs, _ = model.apply(
                {"params": p, "batch_stats": stats64},
                jnp.asarray(batch["imgs"], jnp.float64),
                jnp.asarray(batch["proj_mats"], jnp.float64),
                jnp.asarray(batch["init_depth_min"]),
                jnp.asarray(batch["depth_interval"]), train=True,
                mutable=["batch_stats"])
            return jax_sl1_loss(outs, depths, masks)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(f64(params))
        grads = jax.device_get(grads)
    named = state_dict_from_jax(grads, jax.device_get(stats))
    return {k: v.double().numpy() for k, v in named.items()}, float(loss)


def _relative(got: dict, want: dict) -> float:
    a = np.concatenate([got[k].ravel() for k in sorted(got)])
    b = np.concatenate([want[k].ravel() for k in sorted(got)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_float64_gradient(sampling, img_wh, monkeypatch):
    monkeypatch.setattr(jax_ps, "patch_config", lambda C, D: None)
    monkeypatch.setattr(jax_ps, "banded_cfg", lambda *a, **k: None)
    batch = _batch(img_wh)
    port, port_loss = _port_gradient(sampling, batch)
    moved, _ = _port_gradient(sampling, batch, rescale=1.0 + RESCALE)
    want, jax_loss = _jax_gradient(sampling, batch)
    assert np.isclose(port_loss, jax_loss, rtol=1e-6, atol=0)
    sensitivity = _relative(moved, port)
    gap = _relative(port, want)
    print(f"float64 gradient {sampling} {img_wh}: relative L2 to jax.grad "
          f"{gap!r}, the step's move under a {RESCALE} rescale of the "
          f"images {sensitivity!r}")
    assert sensitivity < 1e-2
    assert gap <= SENSITIVITY_FACTOR * sensitivity, (gap, sensitivity)


@pytest.mark.slow
@pytest.mark.parametrize("sampling", ["auto", "window"])
@pytest.mark.parametrize("img_wh", [(64, 64), (640, 512)],
                         ids=["64x64", "640x512"])
def test_float64_gradient_matches_jax_grad(img_wh, sampling, monkeypatch):
    """640x512 is the reference training shape; 64x64 the same check at a
    size this repository's CPU hosts run in ~90 s a case."""
    check_float64_gradient(sampling, img_wh, monkeypatch)
