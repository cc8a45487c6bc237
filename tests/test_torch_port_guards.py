"""Cheap guards on the port: no JAX inside it, no CPU fallback on the card
path, and its main paths (inference and a train step) run end to end on
the CPU at a small size without launching a kernel."""
import math
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax_pil_or_cv2():
    code = (
        "import pkgutil, sys, casmvsnet_pl_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'PIL', 'cv2', 'casmvsnet_pl_tpu'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_runs_on_cpu_at_small_size():
    from casmvsnet_pl_tpu_torch.entry import entry
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda

    fn, args = entry("cpu", batch=2, img_wh=(64, 32))
    before = cost_volume_cuda.launches
    depth, conf = fn(*args)
    assert cost_volume_cuda.launches == before
    assert depth.shape == (2, 32, 64) and conf.shape == (2, 8, 16)
    assert depth.dtype == conf.dtype == torch.float32
    assert torch.isfinite(depth).all() and torch.isfinite(conf).all()
    assert 0 <= conf.min() and conf.max() <= 1
    # the two samples are the same scene: the batch axis must not mix them
    torch.testing.assert_close(depth[0], depth[1])


def test_train_entry_steps_on_cpu_without_kernels():
    from casmvsnet_pl_tpu_torch.entry import train_entry
    from casmvsnet_pl_tpu_torch.kernels import (cost_volume_bwd_cuda,
                                                cost_volume_cuda)

    trainer, state, batch = train_entry("cpu", img_wh=(64, 32),
                                        n_depths=(8, 8, 8))
    assert trainer.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert batch["imgs"].shape == (2, 3, 32, 64, 3)
    launches = cost_volume_cuda.launches, cost_volume_bwd_cuda.launches
    state, logs = trainer.train_step(state, batch)
    assert (cost_volume_cuda.launches,
            cost_volume_bwd_cuda.launches) == launches == (0, 0)
    assert state.step == 1
    assert sorted(logs) == ["lr", "train/abs_err", "train/acc_1mm",
                            "train/acc_2mm", "train/acc_4mm", "train/loss"]
    assert all(math.isfinite(float(v)) for v in logs.values())
    grads = [p.grad for p in state.model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_bwd_kernel_refuses_cpu_tensors():
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_bwd_cuda

    feats = torch.rand(1, 3, 8, 8, 8)
    proj = torch.zeros(1, 2, 3, 4)
    dv = torch.ones(1, 8, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_bwd_cuda(feats, proj, dv, torch.zeros(1, 8, 8, 8, 8))
    assert cost_volume_bwd_cuda.launches == 0
