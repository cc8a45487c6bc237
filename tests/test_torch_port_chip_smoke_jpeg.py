"""``chip_smoke.py``'s JPEG-datasets path (phases 37-40) rehearsed on the
CPU at a small size, as tests/test_torch_port_chip_smoke_train.py
rehearses the train CLI's: the card's calls stubbed (the kernel checks
against their plain versions among them: the wrappers refuse CPU
tensors), every other check of the phases run."""
import os

import pytest
import torch

import chip_smoke
import eval_torch
import train_torch
from casmvsnet_pl_tpu_torch.data import BlendedMVSDataset, dataset_dict
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.probes import k1
from casmvsnet_pl_tpu_torch.utils import save_checkpoint


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SmallBlendedMVS(BlendedMVSDataset):
    """The reader at 64x64: train_torch.py takes its default size."""

    def __init__(self, *args, img_wh=(64, 64), **kw):
        super().__init__(*args, img_wh=img_wh, **kw)


def test_chip_smoke_jpeg_phases_rehearse_on_cpu(monkeypatch, capsys,
                                                 tmp_path):
    """Phases 37-40 end to end on the CPU: BlendedMVS at 64x64 (its tree
    at the native 768x576), Tanks at 96x64 from JPEGs at a tenth of
    1920x1080, f32, n_depths 8/8/8, no kernel launches expected. The
    fused ground-truth clouds are held to the card's bounds."""
    for name, value in (("DEVICE", "cpu"), ("JPEG_SIZES", ((768, 576),)),
                        ("BMVS_WH", (64, 64)), ("BMVS_EPOCH", {}),
                        ("DEFAULT_FWD", {}), ("TANKS_WH", (96, 64)),
                        ("TANKS_MEMORY_WH", (128, 64)),
                        ("TANKS_IMAGE_SCALE", 0.1)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda *a: None),
                        ("reset_peak_memory_stats", lambda: None),
                        ("max_memory_allocated", lambda: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    checked = []
    monkeypatch.setattr(k1, "check", lambda *a, **kw: checked.append("k1"))
    monkeypatch.setattr(chip_smoke, "check_bwd",
                        lambda *a, **kw: checked.append("k2"))
    monkeypatch.setitem(dataset_dict, "blendedmvs", SmallBlendedMVS)
    for mod in (train_torch, eval_torch):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda args: torch.device("cpu"))
    cli_args = chip_smoke.cli_args
    small = ("--precision", "f32", "--n_depths", "8", "8", "8")
    monkeypatch.setattr(chip_smoke, "cli_args", lambda tree, *flags:
                        cli_args(tree, *small, *flags))
    get_opts = eval_torch.get_opts
    monkeypatch.setattr(eval_torch, "get_opts", lambda argv: get_opts(
        list(argv) + ["--precision", "f32", "--n_depths", "8", "8", "8"]
        if "--precision" not in argv else list(argv) + ["--n_depths", "8",
                                                        "8", "8"]))
    # phase 34's DTU checkpoint: seeded weights of the same model
    model = CascadeMVSNet(n_depths=(8, 8, 8))
    init_weights(model, torch.Generator().manual_seed(5))
    save_checkpoint(str(tmp_path / "dtu_last.ckpt"), {
        "params": {k: v.detach() for k, v in model.named_parameters()},
        "batch_stats": dict(model.named_buffers())})
    monkeypatch.chdir(tmp_path)
    cwd = os.getcwd()
    paths = chip_smoke.jpeg_path("cpu rehearsal", str(tmp_path))
    assert os.getcwd() == cwd
    assert checked == ["k1", "k2"]
    assert set(paths) == {"bmvs_train", "tanks_eval", "bmvs_eval"}
    assert not any(n for counts in paths.values() for n in counts.values())
    out = capsys.readouterr().out
    for what in ("jpeg 768x576 baseline 4:2:0", "jpeg 768x576 progressive",
                 "blendedmvs tree:", "--dataset_name blendedmvs "
                 "--depth_interval 192", "timing blendedmvs train step",
                 "parameters equal to the checkpoint's", "tanks tree:",
                 "tanks inference bf16 96x64x5", "tanks f32 view",
                 "tanks bf16 forward 128x64x5", "tanks fusion of ground-truth",
                 "--split val --save_visual",
                 "blendedmvs fusion of ground-truth", "phases 37-40"):
        assert what in out, what
