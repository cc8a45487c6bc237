"""``eval_torch.py`` against ``eval.py`` on the JPEG datasets: inference to
PFM maps and fusion into a PLY on a synthetic Tanks and Temples tree
(intermediate split, Family's JPEGs at a tenth of 1920x1080, 5 cameras,
3 views at 96x64, n_depths 8/8/16, f32) with the same weights (a JAX
checkpoint and the port's conversion of it); ``--save_visual``'s two
JPEGs a view from the same maps; and the fusion of a synthetic BlendedMVS
tree's ground-truth depths (``eval_torch.main --dataset_name blendedmvs
--skip_inference`` against ``eval.py``'s ``run_fusion``).

Tolerances: depth within 4.7e-5 scene units, the JAX suite's 0.05 mm at
DTU's 2.65 mm interval taken as the same share of Family's 2.5e-3;
confidence within 1e-4; the fused cloud's point count within 1 % (as
tests/test_torch_port_eval.py). The visual files: equal to the bit
decoded by PIL, and the same bytes. The BlendedMVS cloud: the same point
count within 1 %, on the plane z = 125 + 0.3 x (the scene rescaled by
100 / depth_min) within 0.01 units on average and 1 at most, the error of
a nearest resize of the 768x576 depths to 96x64.
"""
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import eval as jax_eval  # noqa: E402
import eval_torch  # noqa: E402
from casmvsnet_pl_tpu.data import TanksDataset as JaxTanks  # noqa: E402
from casmvsnet_pl_tpu.data import dataset_dict as jax_dataset_dict
from casmvsnet_pl_tpu.data import read_pfm as jax_read_pfm  # noqa: E402
from casmvsnet_pl_tpu.fusion import read_ply as jax_read_ply  # noqa: E402
from casmvsnet_pl_tpu.utils import load_checkpoint as jax_load_checkpoint
from casmvsnet_pl_tpu.utils import save_checkpoint as jax_save_checkpoint
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch.data import (BlendedMVSDataset, TanksDataset,
                                         read_pfm, save_pfm,
                                         write_blendedmvs_tree,
                                         write_tanks_tree)
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.fusion import read_ply
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import save_checkpoint, state_dict_from_jax

N_DEPTHS, RATIOS = (8, 8, 16), (1.0, 2.0, 4.0)
IMG_WH = (96, 64)
DEPTH_TOL = 0.05 / 2.65 * 2.5e-3
FLAGS = ["--dataset_name", "tanks", "--split", "intermediate", "--scan",
         "Family", "--n_views", "3", "--img_wh", str(IMG_WH[0]),
         str(IMG_WH[1]), "--n_depths", "8", "8", "16", "--interval_ratios",
         "1", "2", "4", "--precision", "f32", "--conf", "0.1",
         "--min_geo_consistent", "1"]


def _jax_checkpoint(path: str) -> None:
    """Seeded weights with a sharpened softmax over depth (so that the
    depths spread over the sweep), written as a JAX checkpoint."""
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
    init_weights(model, torch.Generator().manual_seed(4))
    with torch.no_grad():
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    params, stats, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    jax_save_checkpoint(path, {"params": params, "batch_stats": stats})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tanks"))
    write_tanks_tree(root, n_cams=5, image_scale=0.1)
    return root


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """Both scripts' step 1 and step 2 on the tree, each in its own
    directory: (jax results dir, port results dir)."""
    ckpts = tmp_path_factory.mktemp("ckpts")
    jax_ckpt, port_ckpt = str(ckpts / "jax.ckpt"), str(ckpts / "port.ckpt")
    _jax_checkpoint(jax_ckpt)
    ckpt = jax_load_checkpoint(jax_ckpt)
    save_checkpoint(port_ckpt, {"params": state_dict_from_jax(
        ckpt["params"], ckpt["batch_stats"])})
    out = []
    cwd = os.getcwd()
    for name, mod, cls, ckpt_path, extra in (
            ("jax", jax_eval, JaxTanks, jax_ckpt, []),
            ("port", eval_torch, TanksDataset, port_ckpt, ["--cpu"])):
        work = tmp_path_factory.mktemp(name)
        os.chdir(work)
        try:
            args = mod.get_opts(["--root_dir", tree, "--ckpt_path",
                                 ckpt_path] + FLAGS + extra)
            dataset = cls(tree, "intermediate", n_views=3, img_wh=IMG_WH)
            mod.run_inference(args, dataset, ["Family"])
            mod.run_fusion(args, dataset, ["Family"])
        finally:
            os.chdir(cwd)
        out.append(os.path.join(str(work), "results", "tanks"))
    return out


@pytest.mark.parametrize("vid", range(5))
def test_pfm_maps_match_eval_py(runs, vid):
    jax_dir, port_dir = runs
    W, H = IMG_WH
    for name, shape, tol in (("depth", (H, W), DEPTH_TOL),
                             ("proba", (H // 4, W // 4), 1e-4)):
        rel = f"depth/Family/{name}_{vid:04d}.pfm"
        got, _ = read_pfm(os.path.join(port_dir, rel))
        want, _ = jax_read_pfm(os.path.join(jax_dir, rel))
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err < tol, f"{rel}: max err {err}"
    depth, _ = read_pfm(os.path.join(port_dir,
                                     f"depth/Family/depth_{vid:04d}.pfm"))
    # not a constant map: it spans more than one of Family's 2.5e-3 steps
    assert np.ptp(depth) > 2.5e-3, "degenerate depth map"


def test_fused_cloud_matches_eval_py(runs):
    jax_dir, port_dir = runs
    xyz, rgb = read_ply(os.path.join(port_dir, "points/Family.ply"))
    jxyz, jrgb = jax_read_ply(os.path.join(jax_dir, "points/Family.ply"))
    assert len(jxyz) > 100 and rgb.dtype == np.uint8
    assert abs(len(xyz) - len(jxyz)) <= 0.01 * len(jxyz), (len(xyz),
                                                           len(jxyz))


class _FixedMaps:
    """A predictor of both scripts' shape that returns the same maps for
    every view: a depth ramp with zeros (the visual's positive range) and
    a confidence field around the threshold."""

    device = torch.device("cpu")

    def __init__(self):
        W, H = IMG_WH
        rng = np.random.RandomState(11)
        depth = np.linspace(0.8, 1.3, W, dtype=np.float32)[None].repeat(H, 0)
        depth[rng.rand(H, W) < 0.1] = 0.0
        self.depth = depth[None]
        self.proba = rng.rand(1, H // 4, W // 4).astype(np.float32)

    def __call__(self, *args, **kw):
        return self.depth, self.proba


def test_save_visual_files_equal_eval_py(tree, tmp_path, monkeypatch):
    maps = _FixedMaps()

    def torch_maps(*args, **kw):
        return torch.from_numpy(maps.depth), torch.from_numpy(maps.proba)

    torch_maps.device = maps.device
    monkeypatch.setattr(jax_eval, "build_predictor", lambda args: maps)
    flags = ["--root_dir", tree, "--save_visual"] + FLAGS
    dirs = []
    for name, mod, cls, extra, kw in (
            ("jax", jax_eval, JaxTanks, [], {}),
            ("port", eval_torch, TanksDataset, ["--cpu"],
             {"predict": torch_maps})):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        args = mod.get_opts(flags + extra)
        dataset = cls(tree, "intermediate", n_views=3, img_wh=IMG_WH)
        mod.run_inference(args, dataset, ["Family"], **kw)
        dirs.append(work / "results/tanks/depth/Family")
    jax_dir, port_dir = dirs
    for vid in range(5):
        for name in (f"depth_visual_{vid:04d}.jpg",
                     f"proba_visual_{vid:04d}.jpg"):
            want = np.asarray(Image.open(jax_dir / name).convert("RGB"))
            got = np.asarray(Image.open(port_dir / name).convert("RGB"))
            assert np.array_equal(got, want), name
            assert (jax_dir / name).read_bytes() == \
                (port_dir / name).read_bytes(), name


def test_blendedmvs_fused_cloud_matches_eval_py(tmp_path, monkeypatch):
    """Fusion of the same ground-truth depth maps (confidence 1) through
    both scripts' BlendedMVS paths: each view's image and projection."""
    root = write_blendedmvs_tree(str(tmp_path / "bmvs"), n_cams=5)
    scan, wh = "synth_val", (96, 64)
    ds = BlendedMVSDataset(root, "val", n_views=3, depth_interval=192,
                           img_wh=wh)
    flags = ["--dataset_name", "blendedmvs", "--root_dir", root, "--split",
             "val", "--n_views", "3", "--img_wh", str(wh[0]), str(wh[1]),
             "--depth_interval", "192", "--skip_inference", "--conf", "0.5",
             "--min_geo_consistent", "2"]
    clouds = []
    for name in ("jax", "port"):
        work = tmp_path / name
        depth_dir = work / f"results/blendedmvs/depth/{scan}"
        depth_dir.mkdir(parents=True)
        monkeypatch.chdir(work)
        for vid in range(5):
            depth = ds.read_depth_and_mask(scan, vid, 0.0)[0]["level_0"]
            save_pfm(str(depth_dir / f"depth_{vid:04d}.pfm"), depth)
            save_pfm(str(depth_dir / f"proba_{vid:04d}.pfm"),
                     np.ones((wh[1] // 4, wh[0] // 4), np.float32))
        ply = f"results/blendedmvs/points/{scan}.ply"
        if name == "jax":
            args = jax_eval.get_opts(flags)
            jds = jax_dataset_dict["blendedmvs"](
                root, "val", n_views=3, depth_interval=192, img_wh=wh)
            jax_eval.run_fusion(args, jds, jds.scans)
            clouds.append(jax_read_ply(ply))
        else:
            assert eval_torch.main(flags + ["--cpu"]) == 0
            clouds.append(read_ply(ply))
    (jxyz, _), (xyz, rgb) = clouds
    assert len(jxyz) > 1000 and rgb.dtype == np.uint8
    assert abs(len(xyz) - len(jxyz)) <= 0.01 * len(jxyz), (len(xyz),
                                                           len(jxyz))
    off = np.abs(xyz[:, 2] - (125.0 + 0.3 * xyz[:, 0]))
    assert off.mean() < 0.01 and off.max() < 1.0, (off.mean(), off.max())
