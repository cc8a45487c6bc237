"""``multicard_smoke.py`` and ``scripts/debug_dp_torch.py`` rehearsed on the
CPU: two processes over gloo at 64x64 (n_depths 8/8/8), as
tests/test_torch_port_chip_smoke_train.py rehearses ``chip_smoke.py``'s
train CLI path. No kernel launches are expected on the CPU
(``DEFAULT_STEP`` empty); the f32 step is held to the CPU bounds of
tests/test_torch_port_dist.py (gradients 0.5, statistics 1e-4), since this
small step amplifies rounding. The card's NCCL runs are
``multicard_smoke.py`` itself, on four cards."""
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
import multicard_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import debug_dp_torch  # noqa: E402


@pytest.fixture(autouse=True)
def rehearsal(monkeypatch):
    """One intra-op thread (the ranks split this process's threads), the
    CPU and a small size."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (64, 64)),
                        ("DEFAULT_STEP", {}), ("DP_N_DEPTHS", (8, 8, 8)),
                        ("GRAD_REL_TOL", 0.5), ("DP_STAT_TOL", 1e-4)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (64, 64)),
                        ("TRAIN_NATIVE_WH", (256, 256)),
                        ("TRAIN_CROP", ((32, 96), (32, 96))),
                        ("TRAIN_FOCAL", 100.0), ("TRAIN_CAMS", 3),
                        ("CLI_EPOCHS", 1),
                        ("M2_STEPS", 3), ("M4_WARMUP", 1), ("M4_STEPS", 2),
                        ("M4_PROFILE_STEPS", 1), ("CLI_TIMEOUT_S", 300),
                        ("TIMEOUT_S", 240),
                        ("CLI_FLAGS", ("--cpu", "--precision", "bf16",
                                       "--n_depths", "8", "8", "8",
                                       "--num_workers", "1"))):
        monkeypatch.setattr(multicard_smoke, name, value)
    yield
    torch.set_num_threads(n)


def test_m1_one_step_rehearses_on_cpu(tmp_path, capsys):
    """M1: two gloo ranks' f32 step against one process (and its rows
    permuted), through ``debug_dp_torch.py`` and chip_smoke's bounds."""
    multicard_smoke.one_step(str(tmp_path), 2, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "data-parallel f32 SGD step, 2 ranks on the CPU over gloo" in out
    assert "ranks' gradients equal True" in out


def test_m2_replicas_rehearse_on_cpu(tmp_path, capsys):
    """M2: bf16 (CPU autocast) Adam steps; the replicas equal to the bit
    and the first step's 81 all-reduces float32 and alike on both ranks."""
    multicard_smoke.replicas(str(tmp_path), 2, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "parameters equal to the bit across the ranks True, buffers " \
        "True" in out
    assert "all-reduces from Python: 81 (expected 81: 38 BatchNorm " \
        "layers), dtypes ['torch.float32']" in out


def test_m3_cli_rehearses_on_cpu(tmp_path, capsys):
    """M3: ``train_torch.py --num_devices 2 --cpu`` and ``torchrun
    --nproc_per_node 2`` through ``multicard_smoke.py train``, the val
    metrics against one process's validation of the checkpoint, the
    one-process resume and warm start."""
    cwd = os.getcwd()
    multicard_smoke.cli(str(tmp_path), 2, "cpu rehearsal")
    assert os.getcwd() == cwd
    out = capsys.readouterr().out
    for what in ("M3 train_torch.py --num_devices 2 --batch_size 4",
                 "M3 one process --resume_path last.ckpt, one more epoch: "
                 "step 10 (after 5 a epoch)",
                 "every parameter equal to the checkpoint's True",
                 "M3 torchrun --nproc_per_node 2 train_torch.py"):
        assert what in out, what


def test_m4_scaling_rehearses_on_cpu(tmp_path, capsys):
    """M4's code path (the host clock on the CPU, no NCCL kernels)."""
    rows = multicard_smoke.scaling(str(tmp_path), 2, "cpu rehearsal")
    assert [r["cards"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["ms"] > 0 and r["nccl_count"] == 0 for r in rows)
    assert "M4 weak scaling [" in capsys.readouterr().out


def test_debug_dp_torch_runs_two_ranks_on_cpu(capsys):
    """``scripts/debug_dp_torch.py --cpu``: the same step on two gloo
    ranks as in one process, in float64 (where the two agree to rounding)."""
    got = debug_dp_torch.main(["--cpu", "--ranks", "2", "--img_wh", "32",
                               "32", "--n_depths", "8", "8", "8", "--dtype",
                               "float64"])
    one = got["reference"][0]
    assert got["same"]
    assert abs(got["ranks"][0]["loss"] - one["loss"]) < 1e-5 * abs(
        one["loss"])
    assert max(got["grads"].values()) < 1e-5, got["grads"]
    assert max(got["stats"].values()) < 1e-5, got["stats"]
    out = capsys.readouterr().out
    assert "n_ranks=2 loss=" in out and "--- batch_stats diffs ---" in out


@pytest.mark.parametrize("script", [["multicard_smoke.py"],
                                    ["scripts/debug_dp_torch.py"]])
def test_fails_without_enough_cards(script):
    """Without cards (or with fewer than the ranks) both exit 1 and start
    no rank: neither falls back to gloo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert "visible" in proc.stderr
