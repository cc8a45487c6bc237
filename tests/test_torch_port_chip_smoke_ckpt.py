"""``chip_smoke.py``'s checkpoint path (phases 41-43: a reference
Lightning ``.ckpt`` and a JAX-layout msgpack converted, ``demo_torch.py``
and ``eval_torch.py --ckpt_path`` on the converted files) rehearsed on the
CPU at a small size, as tests/test_torch_port_chip_smoke_jpeg.py
rehearses phases 37-40: the card's calls stubbed, no kernel launches
expected, every other check of the phases run."""
import os

import pytest
import torch

import chip_smoke
import demo_torch
import eval_torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_checkpoint_phases_rehearse_on_cpu(monkeypatch, capsys,
                                                      tmp_path):
    """Phases 41-43 end to end on the CPU: the demo at 64x64 in bf16 as on
    the card, the eval view at 64x64x5 from a tree at 128x128."""
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (64, 64)),
                        ("EVAL_WH", (64, 64)),
                        ("EVAL_NATIVE_WH", (128, 128)),
                        ("EVAL_FOCAL", 200.0), ("DEFAULT_FWD", {}),
                        ("DEMO_TIME_ITERS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda *a: None),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    for mod in (demo_torch, eval_torch):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda args: torch.device("cpu"))
    chip_smoke.eval_tree(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cwd = os.getcwd()
    paths = chip_smoke.checkpoint_path("cpu rehearsal", str(tmp_path))
    assert os.getcwd() == cwd
    assert set(paths) == {"demo", "demo_jax", "eval_converted"}
    assert all(n == 0 for counts in paths.values() for n in counts.values())
    out = capsys.readouterr().out
    for what in ("convert: skipped 1 non-model keys: ['loss.weights']",
                 "wrote ", "reference .ckpt (legacy format) converted: 130 "
                 "parameters and 114 buffers, 0 unequal",
                 "demo f32 forward of the converted weights, K1 vs plain",
                 "demo_torch.main --ckpt_path <converted reference .ckpt>: ",
                 "ms per view", "demo from the converted reference .ckpt vs "
                 "the original model: max|d depth_0| 0.0 mm",
                 "JAX-layout msgpack converted: 130 parameters",
                 "demo from the converted JAX checkpoint vs phase 41's: "
                 "max|d depth_0| 0.0 mm",
                 "eval_torch --ckpt_path <converted reference .ckpt> "
                 "(load_state_dict strict=True), 64x64x5",
                 "checkpoint path (phases 41-43)"):
        assert what in out, what
