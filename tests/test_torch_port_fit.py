"""Training converges on the CPU: the port's trainer from ``train_entry``
fits eight 32x32 plane scenes (n_depths 8/8/8, B=2, Adam lr 1e-3 with a
cosine schedule over the 24 epochs) and validates on seven of them, the
last batch padded.

The CPU backward's scatter-adds sum in a thread-dependent order, so the
fit runs on one thread, where its trajectory is fixed. Measured
val/abs_err (mm): 10.53 before training, then 10.53 10.54 10.56 10.62
10.63 10.26 9.33 8.04 5.99 5.64 4.21 4.64 6.93 6.29 6.09 5.51 4.83 5.23
5.18 5.08 5.01 4.86 5.05 4.88 after epochs 1-24 (~10 s). The bound, 8.0
mm, sits 1.6x above the last epochs' 4.8-5.2 and well below the
untrained 10.5.
"""
import os

import numpy as np
import torch

from casmvsnet_pl_tpu_torch.data import DataLoader, PlaneScene
from casmvsnet_pl_tpu_torch.entry import train_entry
from casmvsnet_pl_tpu_torch.kernels import (cost_volume_bwd_cuda,
                                            cost_volume_cuda)

EPOCHS = 24


def _sample(i):
    scene = PlaneScene(img_wh=(32, 32), n_views=3, z0=440.0 + 6.0 * i,
                       slope_x=0.05 * (i - 4), seed=i)
    imgs, proj, depths = scene.model_inputs()
    return {"imgs": imgs[0], "proj_mats": proj[0],
            "init_depth_min": np.float32(425.0),
            "depth_interval": np.float32(2.65),
            "depths": {k: v[0] for k, v in depths.items()},
            "masks": {k: np.ones(v[0].shape, bool) for k, v in depths.items()}}


def test_fit_converges_on_cpu(tmp_path):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)          # one summation order: a fixed trajectory
    try:
        _fit_and_check(tmp_path)
    finally:
        torch.set_num_threads(n_threads)


def _fit_and_check(tmp_path):
    scenes = [_sample(i) for i in range(8)]
    train = DataLoader(scenes, 2, shuffle=True, num_workers=2)
    val = DataLoader(scenes[:7], 2, shuffle=False, drop_last=False,
                     pad_last=True, num_workers=2)
    ckpt_dir = str(tmp_path / "ckpts")
    trainer, state, _ = train_entry(
        "cpu", img_wh=(32, 32), n_depths=(8, 8, 8), optimizer="adam",
        lr=1e-3, steps_per_epoch=len(train),
        optim_kwargs=dict(lr_scheduler="cosine", num_epochs=EPOCHS),
        ckpt_dir=ckpt_dir, log_dir=None)
    launches = cost_volume_cuda.launches, cost_volume_bwd_cuda.launches
    before = trainer.validate(state, val)
    state = trainer.fit(state, train, val, num_epochs=EPOCHS, progress=False)
    after = trainer.validate(state, val)
    assert (cost_volume_cuda.launches,
            cost_volume_bwd_cuda.launches) == launches
    assert state.step == EPOCHS * 4
    assert before["val/abs_err"] > 10.0, before
    assert np.isfinite(after["val/loss"])
    assert after["val/loss"] < before["val/loss"], (before, after)
    assert after["val/abs_err"] < 8.0, (before, after)
    files = os.listdir(ckpt_dir)
    assert "last.ckpt" in files and "index.json" in files
    assert 1 <= sum(f.startswith("epoch=") for f in files) <= 5
    resumed = trainer.restore_state(os.path.join(ckpt_dir, "last.ckpt"))
    assert resumed.step == state.step
