"""``chip_smoke.py``'s window path (phases 44-48: the window sampler, the
window forward, train step and eval view, ``utils/profiling``) rehearsed
on the CPU at a small size, as tests/test_torch_port_chip_smoke_ckpt.py
rehearses phases 41-43: the card's calls stubbed (CUDA events count 1 ms,
the memory helpers report one card), no kernel launches expected, every
other check of the phases run."""
import os

import pytest
import torch

import chip_smoke
import eval_torch
from casmvsnet_pl_tpu_torch import utils
from casmvsnet_pl_tpu_torch.entry import entry, train_entry


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("CASMVS_ENABLE_WINDOW_SAMPLING", raising=False)
    yield
    torch.set_num_threads(n)


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_chip_smoke_window_phases_rehearse_on_cpu(monkeypatch, capsys,
                                                  tmp_path):
    """Phases 44-48 end to end on the CPU: the forwards and train steps at
    64x64, the eval view at 64x64x5 from a tree at 128x128."""
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (64, 64)),
                        ("EVAL_WH", (64, 64)),
                        ("EVAL_NATIVE_WH", (128, 128)),
                        ("EVAL_FOCAL", 200.0), ("DEFAULT_FWD", {}),
                        ("WINDOW_FWD", {}), ("WINDOW_STEP", {}),
                        ("WINDOW_TRAIN_STEPS", 2),
                        ("profile", lambda *a, **k: None)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda *a: None),
                        ("reset_peak_memory_stats", lambda: None),
                        ("max_memory_allocated", lambda: 0),
                        ("empty_cache", lambda: None), ("Event", _Event),
                        ("device_count", lambda: 1)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(utils, "device_memory_stats", lambda: [
        {"device": "cuda:0 rehearsal", "bytes_in_use": 1,
         "peak_bytes_in_use": 1, "bytes_limit": 1}])
    monkeypatch.setattr(eval_torch, "resolve_device",
                        lambda args: torch.device("cpu"))
    chip_smoke.eval_tree(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    inputs = chip_smoke.level_inputs()
    inputs2 = chip_smoke.level_inputs(batch=2)
    paths = chip_smoke.window_path(entry, train_entry, inputs, inputs2,
                                   str(tmp_path), "cpu rehearsal")
    assert os.getcwd() == str(tmp_path)
    assert set(paths) == {"window_inference", "window_train", "window_eval"}
    assert all(n == 0 for counts in paths.values() for n in counts.values())
    # the variable is set only while the eval flags are parsed
    assert "CASMVS_ENABLE_WINDOW_SAMPLING" not in os.environ
    out = capsys.readouterr().out
    for what in ("window-check L0 B=1 64x64 C=8 D=8 card vs CPU: sampler "
                 "f32 max_abs_err=0.0",
                 "window-check L0 B=2", "groups overflowing the window 0.0",
                 "timing cost volume L0 bf16 B=1 forward: window",
                 "timing cost volume L0 bf16 B=2 forward + backward",
                 "forward f32 sampling=window vs default: max|d depth_0|=",
                 "forward bf16 sampling=window main path",
                 "timing forward sampling=window bf16 B=4",
                 "train step f32 sampling=window kernel vs plain",
                 "train bf16 sampling=window 64x64x3 B=2",
                 "timing train step sampling=window",
                 "eval inference bf16 --sampling window 64x64x5, 5 views",
                 "profiling.trace of one bf16 window forward",
                 "0 of them cost_volume_kernel",
                 "window path (phases 44-48)"):
        assert what in out, what
