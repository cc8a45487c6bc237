"""One training step of the port against the JAX package's trainer.

B=2 distinct plane scenes (as tests/test_train_loop.py builds them, at
64x64), n_depths (8, 8, 8), 3 views, float32, SGD with lr 1e-2 and neither
momentum nor weight decay, so the parameter change is the gradient times
the learning rate. The JAX ``MVSTrainer`` runs on ``make_mesh(1)``; the
port's ``MVSTrainer`` starts from the same weights (``state_dict_from_jax``)
and fresh optimizer state. ~30 s on one worker, most of it the JAX
trainer's compile.

Why 64x64 and not 32x32: at 32x32 the level-2 U-Net's innermost
BatchNorms normalize over 2 values per channel (B=2, D=H=W=1), and f32
rounding is amplified there. The JAX trainer's own f32 gradient of the
early FeatureNet leaves then sits 1.5 % from a float64 run of the same
step (the port's f32 gradient 0.3 %), beyond the bound below for a leaf
that starts at zero. At 64x64 (8 values per channel) every leaf is within
a quarter of the bound.

The update itself (a - a0 against JAX's b - a0) is held by relative L2, at
1e-2 over all leaves together and 0.1 per leaf; the prob convs' biases,
whose exact gradient is 0 (the softmax over depth ignores a constant
shift), against their weights' update. Not tighter, because the step is
sensitive to rounding at this size: rescaling the images by 1 + 1e-7 moves
the port's own update by 4.1e-3 over all leaves and by up to 1.7 % in one
leaf (cost_reg_1.conv4.bn.bias), as large as the gap to JAX (3.4e-3 and
2.2 %, cost_reg_0.conv5.bn.bias). The gradients of each module in train
mode are held to 1e-4 in test_torch_port_train_modules.py, and the loss's
in test_torch_port_optim.py.
"""
import jax
import numpy as np
import torch

from casmvsnet_pl_tpu.data.loader import collate as jax_collate
from casmvsnet_pl_tpu.engine import MVSTrainer as JaxTrainer
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.parallel import make_mesh
from casmvsnet_pl_tpu.utils import OptimConfig as JaxOptimConfig
from casmvsnet_pl_tpu_torch.data import PlaneScene, collate
from casmvsnet_pl_tpu_torch.engine import MVSTrainer
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import OptimConfig, state_dict_from_jax

N_DEPTHS, RATIOS = (8, 8, 8), (1.0, 2.0, 4.0)


def _samples(n=2):
    out = []
    for i in range(n):
        scene = PlaneScene(img_wh=(64, 64), n_views=3, z0=440.0 + 8.0 * i,
                           slope_x=0.05 * (i - 4), seed=i)
        imgs, proj, depths = scene.model_inputs()
        out.append({
            "imgs": imgs[0], "proj_mats": proj[0],
            "init_depth_min": np.float32(425.0),
            "depth_interval": np.float32(2.65),
            "depths": {k: v[0] for k, v in depths.items()},
            "masks": {k: np.ones(v[0].shape, bool)
                      for k, v in depths.items()},
        })
    return out


def test_train_step_matches_jax_trainer():
    batch = collate(_samples())
    kw = dict(optimizer="sgd", lr=1e-2, momentum=0.0, weight_decay=0.0)

    jt = JaxTrainer(JaxCascade(n_depths=N_DEPTHS, interval_ratios=RATIOS),
                    JaxOptimConfig(**kw), steps_per_epoch=10,
                    mesh=make_mesh(1))
    jstate = jt.init_state(jax_collate(_samples()), seed=0)
    params0, stats0 = jax.device_get((jstate.params, jstate.batch_stats))
    jstate, jlogs = jt.train_step(jstate, jt._device_batch(batch))
    jlogs = jax.device_get(jlogs)
    ref = state_dict_from_jax(*jax.device_get((jstate.params,
                                               jstate.batch_stats)))
    start = state_dict_from_jax(params0, stats0)

    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
    model.load_state_dict(start, strict=True)
    trainer = MVSTrainer(model, OptimConfig(**kw), steps_per_epoch=10)
    state = trainer.init_state()
    state, logs = trainer.train_step(state, trainer.device_batch(batch))

    assert logs.keys() == jlogs.keys()
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-4, err_msg=k)
    got = model.state_dict()
    n_stats = 0
    updates = {}
    for k, want in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = want.double().numpy()
        b = got[k].double().numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=k)
            n_stats += 1
        else:
            # the bound of tests/test_train_loop.py: relative L2 with an
            # absolute floor for leaves that start at zero
            err = np.linalg.norm(a - b)
            tol = 3e-3 * np.linalg.norm(a) + 1e-4 * np.sqrt(a.size)
            assert err < tol, f"{k}: {err:.2e} > {tol:.2e}"
            a0 = start[k].double().numpy()
            updates[k] = (a - a0, b - a0)
    assert len(updates) == len(list(model.parameters()))
    assert n_stats == 2 * sum(1 for m in model.modules()
                              if isinstance(m, torch.nn.modules.batchnorm
                                            ._BatchNorm))

    for k, (da, db) in updates.items():
        scale = np.linalg.norm(updates[k.replace("prob.bias",
                                                 "prob.weight")][0])
        err = np.linalg.norm(da - db) / scale
        assert err < 0.1, f"{k}: update relative L2 {err:.2e}"
    da, db = (np.concatenate([u[i].ravel() for u in updates.values()])
              for i in (0, 1))
    err = np.linalg.norm(da - db) / np.linalg.norm(da)
    assert err < 1e-2, f"update relative L2 over all leaves {err:.2e}"
