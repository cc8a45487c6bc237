"""``chip_smoke.py``'s train CLI path (phases 33-36) rehearsed on the CPU
at a small size, as tests/test_torch_port_eval.py rehearses its eval
path: the card's calls stubbed, every check of the phases run."""
import os

import pytest
import torch

import chip_smoke
import train_torch


@pytest.fixture(autouse=True)
def few_threads():
    """One intra-op thread: the tier-1 run puts several test processes on
    the host's cores, where more threads each slow these steps many
    times over; the ranks spawned here split this process's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_cli_phases_rehearse_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's train CLI path (phases 33-36) end to end on the CPU
    at 32x32 (native 128x128, f32, n_depths 8/8/8): the card's calls
    stubbed, no kernel launches expected. The two-rank step's gradients
    and BatchNorm statistics are held to the float32 bounds of
    tests/test_torch_port_dist.py (0.5 and 1e-4), not the card's: this
    small step amplifies rounding, and one process with the batch's rows
    permuted already moves its gradients by 4.2e-2 and its statistics by
    1.6e-5 here."""
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (32, 32)),
                        ("TRAIN_NATIVE_WH", (128, 128)),
                        ("TRAIN_CROP", ((16, 48), (16, 48))),
                        ("TRAIN_FOCAL", 50.0), ("CLI_EPOCH", {}),
                        ("DEFAULT_STEP", {}), ("DP_N_DEPTHS", (8, 8, 8)),
                        ("GRAD_REL_TOL", 0.5), ("DP_STAT_TOL", 1e-4)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda *a: None),
                        ("reset_peak_memory_stats", lambda: None),
                        ("max_memory_allocated", lambda: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(train_torch, "resolve_device",
                        lambda args: torch.device("cpu"))
    args = chip_smoke.cli_args
    monkeypatch.setattr(chip_smoke, "cli_args", lambda tree, *flags: args(
        tree, "--precision", "f32", "--n_depths", "8", "8", "8", *flags))
    cwd = os.getcwd()
    paths = chip_smoke.cli_path("cpu rehearsal", 1.0)
    assert os.getcwd() == cwd
    assert set(paths) == {"train_cli"}
    assert not any(paths["train_cli"].values())
    out = capsys.readouterr().out
    for what in ("train tree:", "train_torch.py bf16 32x32x3",
                 "timing train_torch.py step", "--resume_path last.ckpt",
                 "--prefixes_to_ignore cost_reg_0: 32 names ignored",
                 "data-parallel f32 SGD step", "phases 33-36"):
        assert what in out, what
