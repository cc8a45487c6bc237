"""``eval_torch.py`` against ``eval.py``: inference to PFM maps and their
fusion into a PLY, on one synthetic DTU tree (64x64, one scan, 5 cameras,
3 views, n_depths 8/8/16, f32) with the same weights: a JAX checkpoint for
``eval.py`` and its conversion by the port's ``utils/convert.py`` for
``eval_torch.py``. Tolerances: depth within 0.05 mm
(tests/test_torch_parity.py), confidence within 1e-4, the fused cloud's
point count within 1 % at --conf 0.1 --min_geo_consistent 1 (as
tests/test_eval_pipeline.py). One JAX compile of the cascade.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import eval as jax_eval  # noqa: E402
import eval_torch  # noqa: E402
from casmvsnet_pl_tpu.data import DTUDataset as JaxDTU  # noqa: E402
from casmvsnet_pl_tpu.data import read_pfm as jax_read_pfm
from casmvsnet_pl_tpu.fusion import read_ply as jax_read_ply
from casmvsnet_pl_tpu.utils import load_checkpoint as jax_load_checkpoint
from casmvsnet_pl_tpu.utils import save_checkpoint as jax_save_checkpoint
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import DTUDataset, read_pfm, write_dtu_tree
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.fusion import read_ply
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import save_checkpoint, state_dict_from_jax

N_DEPTHS, RATIOS = (8, 8, 16), (1.0, 2.0, 4.0)
FLAGS = ["--dataset_name", "dtu", "--split", "test", "--n_views", "3",
         "--img_wh", "64", "64", "--n_depths", "8", "8", "16",
         "--interval_ratios", "1", "2", "4", "--precision", "f32",
         "--conf", "0.1", "--min_geo_consistent", "1"]


def _tiny(base, lists):
    class Tiny(base):
        NATIVE_WH = (256, 256)
        DEPTH_CROP = ((32, 96), (32, 96))
        N_CAMS = 5
        LISTS_DIR = lists
    return Tiny


def _jax_checkpoint(path: str) -> None:
    """Seeded weights with perturbed BN statistics and a sharpened softmax
    over depth (so that the depths spread over the sweep), written as a
    JAX checkpoint."""
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
    init_weights(model, torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.shape
                m.running_mean += torch.from_numpy(
                    rng.randn(*n).astype(np.float32) * 0.05)
                m.running_var *= torch.from_numpy(
                    1 + 0.1 * rng.rand(*n).astype(np.float32))
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    params, stats, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    jax_save_checkpoint(path, {"params": params, "batch_stats": stats})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts' step 1 and step 2 on one tree, each in its own
    directory: (jax results dir, port results dir)."""
    root = str(tmp_path_factory.mktemp("tree"))
    write_dtu_tree(root, scans=("synth1",), n_cams=5, lights=(3,))
    lists = str(tmp_path_factory.mktemp("lists"))
    with open(os.path.join(lists, "test.txt"), "w") as f:
        f.write("synth1\n")
    ckpts = tmp_path_factory.mktemp("ckpts")
    jax_ckpt, port_ckpt = str(ckpts / "jax.ckpt"), str(ckpts / "port.ckpt")
    _jax_checkpoint(jax_ckpt)
    ckpt = jax_load_checkpoint(jax_ckpt)
    save_checkpoint(port_ckpt, {"params": state_dict_from_jax(
        ckpt["params"], ckpt["batch_stats"])})

    out = []
    cwd = os.getcwd()
    for name, mod, base, ckpt_path, extra in (
            ("jax", jax_eval, JaxDTU, jax_ckpt, []),
            ("port", eval_torch, DTUDataset, port_ckpt, ["--cpu"])):
        work = tmp_path_factory.mktemp(name)
        os.chdir(work)
        try:
            args = mod.get_opts(["--root_dir", root, "--ckpt_path", ckpt_path]
                                + FLAGS + extra)
            dataset = _tiny(base, lists)(root, "test", n_views=3,
                                         img_wh=(64, 64))
            mod.run_inference(args, dataset, dataset.scans)
            mod.run_fusion(args, dataset, dataset.scans)
        finally:
            os.chdir(cwd)
        out.append(os.path.join(str(work), "results", "dtu"))
    return out


@pytest.mark.parametrize("vid", range(5))
def test_pfm_maps_match_eval_py(runs, vid):
    jax_dir, port_dir = runs
    for name, shape, tol in (("depth", (64, 64), 0.05),
                             ("proba", (16, 16), 1e-4)):
        rel = f"depth/synth1/{name}_{vid:04d}.pfm"
        got, _ = read_pfm(os.path.join(port_dir, rel))
        want, _ = jax_read_pfm(os.path.join(jax_dir, rel))
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err < tol, f"{rel}: max err {err}"
    assert np.ptp(want) > 0.01 and np.ptp(got) > 0.01
    depth, _ = read_pfm(os.path.join(port_dir,
                                     f"depth/synth1/depth_{vid:04d}.pfm"))
    assert np.ptp(depth) > 1.0, "degenerate depth map"


def test_fused_cloud_matches_eval_py(runs):
    jax_dir, port_dir = runs
    xyz, rgb = read_ply(os.path.join(port_dir, "points/synth1.ply"))
    jxyz, _ = jax_read_ply(os.path.join(jax_dir, "points/synth1.ply"))
    assert len(jxyz) > 100 and rgb.dtype == np.uint8
    assert abs(len(xyz) - len(jxyz)) <= 0.01 * len(jxyz), (len(xyz),
                                                           len(jxyz))


def test_chip_smoke_eval_phases_rehearse_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's eval path (phases 28-32) end to end on the CPU at a
    small size: the card's calls stubbed, no kernel launches expected. A
    pixel of the 64x64 views covers 4.6 mm of the plane (0.26 mm at
    1152x864), so the fused cloud's completeness alone is ~1.3 mm here and
    the ground-truth score is held to 2 mm, not the card's 0.1 mm."""
    for name, value in (("DEVICE", "cpu"), ("EVAL_WH", (64, 64)),
                        ("EVAL_NATIVE_WH", (128, 128)),
                        ("EVAL_MEMORY_WH", (96, 96)), ("EVAL_FOCAL", 200.0),
                        ("GT_TOL_MM", 2.0), ("DEFAULT_FWD", {}),
                        ("EVAL_FWD", {})):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda: None),
                        ("reset_peak_memory_stats", lambda: None),
                        ("max_memory_allocated", lambda: 0),
                        ("memory_allocated", lambda: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(eval_torch, "resolve_device",
                        lambda args: torch.device("cpu"))
    cwd = os.getcwd()
    paths = chip_smoke.eval_path("cpu rehearsal")
    assert os.getcwd() == cwd
    assert set(paths) == {"eval", "eval_g8"}
    assert all(n == 0 for counts in paths.values() for n in counts.values())
    out = capsys.readouterr().out
    for what in ("image libraries:", "eval tree:", "eval inference bf16",
                 "eval f32 view", "eval bf16 view --num_groups 8",
                 "eval bf16 forward 96x96x5", "fusion of ground-truth",
                 "eval fusion on the card", "eval path (phases 28-32)"):
        assert what in out, what
