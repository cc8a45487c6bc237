"""Cheap guards on the port: no JAX inside it, no CPU fallback on the card
path, and its main path runs end to end on the CPU at a small size."""
import os
import subprocess
import sys

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
