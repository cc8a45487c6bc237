"""The port's fusion and DTU scorer against the JAX package's, on the CPU.

Tolerances: the consistency check against the native backend (whose
arithmetic it follows) within 1e-4 relative on depth and 1e-3 on colour
where both accept, masks agreeing on >= 99.9 % of pixels; against the
numpy backend within tests/test_fusion.py's bounds. The confidence upsample
within 1e-5 of OpenCV, back-projection within 1e-4, fused point counts
within 0.1 %, PLY files and scores equal.
"""
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.data.synthetic import PlaneScene
from casmvsnet_pl_tpu.evaluation import evaluate_scan as jax_evaluate_scan
from casmvsnet_pl_tpu.evaluation import aggregate as jax_aggregate
from casmvsnet_pl_tpu.evaluation import reduce_points as jax_reduce_points
from casmvsnet_pl_tpu.fusion import backproject as jax_backproject
from casmvsnet_pl_tpu.fusion import check_geo_consistency_np
from casmvsnet_pl_tpu.fusion import fuse_scan as jax_fuse_scan
from casmvsnet_pl_tpu.fusion import read_ply as jax_read_ply
from casmvsnet_pl_tpu.fusion import write_ply as jax_write_ply
from casmvsnet_pl_tpu.fusion.consistency import check_geo_consistency_native
from casmvsnet_pl_tpu_torch.evaluation import (aggregate, evaluate_scan,
                                               reduce_points)
from casmvsnet_pl_tpu_torch.fusion import (SpillCache, backproject,
                                           check_geo_consistency,
                                           fuse_and_write, fuse_scan,
                                           read_ply, upsample_proba,
                                           write_ply)

T = torch.from_numpy


@pytest.fixture(scope="module")
def scene_views():
    scene = PlaneScene(img_wh=(64, 64), n_views=4, z0=460.0, baseline=15.0,
                       focal=120.0, slope_x=0.2)
    P = scene.proj_mats_level(1.0)
    depths = [scene.depth_map(v) for v in range(4)]
    images = [(scene.render(v) * 255).astype(np.uint8) for v in range(4)]
    return scene, P, depths, images


def _ref_depth(depths, case):
    rng = np.random.RandomState(0)
    d = depths[0].copy()
    if case == "noisy":
        d += rng.randn(*d.shape).astype(np.float32) * 2.0
    elif case == "wrong":
        d *= 1.15
    elif case == "nonfinite":
        d += rng.randn(*d.shape).astype(np.float32) * 2.0
        d[3, :7] = np.nan
        d[5, 9:12] = np.inf
        d[7, 20:30] = 0.0
        d[9, 40:44] = -d[9, 40:44]
    return d


@pytest.mark.parametrize("case", ["true", "noisy", "wrong", "nonfinite"])
@pytest.mark.parametrize("src", [1, 3])
def test_consistency_matches_native_and_numpy(scene_views, case, src):
    _, P, depths, images = scene_views
    ref = _ref_depth(depths, case)
    img = images[src].astype(np.float32)
    d, m, c = check_geo_consistency(T(ref), P[0], T(depths[src]), P[src],
                                    T(img))
    d, m, c = d.numpy(), m.numpy(), c.numpy()
    assert d.dtype == c.dtype == np.float32 and m.dtype == bool
    dn, mn, cn = check_geo_consistency_native(ref, P[0], depths[src], P[src],
                                              img)
    assert (m == mn).mean() >= 0.999
    both = m & mn
    np.testing.assert_allclose(d[both], dn[both], rtol=1e-4)
    np.testing.assert_allclose(c[both], cn[both], atol=1e-3)
    assert not d[~m].any() and not c[~m].any()
    if case == "true":
        assert m[16:48, 16:48].mean() > 0.95
    if case == "wrong":
        assert m[16:48, 16:48].mean() < 0.05
    dp, mp, cp = check_geo_consistency_np(ref, P[0], depths[src], P[src],
                                          img)
    assert (m == mp).mean() > 0.995
    both = m & mp
    assert np.allclose(d[both], dp[both], atol=1e-2)
    assert np.allclose(c[both], cp[both], atol=0.5)


@pytest.mark.parametrize("hw,wh", [((16, 16), (64, 64)),
                                   ((27, 36), (144, 108))])
def test_upsample_proba_matches_opencv(hw, wh):
    proba = np.random.RandomState(hw[0]).rand(*hw).astype(np.float32)
    got = upsample_proba(T(proba), wh).numpy()
    want = cv2.resize(proba, wh, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape == (wh[1], wh[0])
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("skip", [1, 3])
def test_backproject_matches_jax(scene_views, skip):
    _, P, depths, images = scene_views
    rng = np.random.RandomState(skip)
    mask = rng.rand(64, 64) > 0.3
    colors = images[0].astype(np.float64) + rng.randn(64, 64, 3) * 3
    xyz, rgb = backproject(T(depths[0]), T(mask), T(colors), P[0], skip)
    jxyz, jrgb = jax_backproject(depths[0], mask, colors, P[0], skip)
    assert xyz.dtype == np.float32 and rgb.dtype == np.uint8
    assert xyz.shape == jxyz.shape
    np.testing.assert_allclose(xyz, jxyz, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rgb, jrgb)


def _fuse_kwargs(scene_views, depth_of=None):
    scene, P, depths, images = scene_views
    return dict(read_image=lambda v: images[v],
                read_depth=depth_of or (lambda v: depths[v]),
                read_proba=lambda v: np.ones((16, 16), np.float32),
                proj_mat=lambda v: P[v], img_wh=(64, 64), conf=0.5,
                min_geo_consistent=2, skip=1)


@pytest.mark.parametrize("noise", [0.0, 1.5])
def test_fuse_scan_point_count_matches_jax(scene_views, noise):
    _, _, depths, _ = scene_views
    rng = np.random.RandomState(4)
    noisy = [d + rng.randn(*d.shape).astype(np.float32) * noise
             for d in depths]
    metas = [(0, [1, 2, 3]), (1, [0, 2, 3]), (2, [0, 1, 3]), (3, [2, 1, 0])]
    kw = _fuse_kwargs(scene_views, lambda v: noisy[v])
    xyz, rgb = fuse_scan(metas, device="cpu", **kw)
    jxyz, jrgb = jax_fuse_scan(metas, backend="native", **kw)
    assert len(jxyz) > 1000
    assert abs(len(xyz) - len(jxyz)) <= 0.001 * len(jxyz)
    if len(xyz) == len(jxyz):
        np.testing.assert_allclose(xyz, jxyz, atol=1e-2)
        assert np.abs(rgb.astype(int) - jrgb).max() <= 1


def test_fuse_scan_skips_missing_views_and_spills_alike(scene_views):
    _, _, depths, _ = scene_views

    def read_depth(v):
        if v == 0:
            raise FileNotFoundError("no depth")
        return depths[v]

    kw = _fuse_kwargs(scene_views, read_depth)
    kw["min_geo_consistent"] = 1
    xyz, rgb = fuse_scan([(0, [1, 2]), (1, [2, 3])], device="cpu", **kw)
    jxyz, _ = jax_fuse_scan([(0, [1, 2]), (1, [2, 3])], **kw)
    assert 0 < len(xyz) == len(jxyz)
    metas = [(0, [1, 2, 3]), (1, [0, 2, 3]), (2, [0, 1, 3])]
    kw = _fuse_kwargs(scene_views)
    a = fuse_scan(metas, cache_bytes=None, device="cpu", **kw)
    b = fuse_scan(metas, cache_bytes=20_000, device="cpu", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = fuse_scan(metas, max_ref_views=1, device="cpu", **kw)
    assert 0 < len(c[0]) < len(a[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_reads_the_same_in_both_packages(tmp_path, writer):
    rng = np.random.RandomState(0)
    xyz = rng.randn(100, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (100, 3)).astype(np.uint8)
    path = str(tmp_path / "x.ply")
    (write_ply if writer == "port" else jax_write_ply)(path, xyz, rgb)
    for reader in (read_ply, jax_read_ply):
        x, c = reader(path)
        np.testing.assert_array_equal(x, xyz)
        np.testing.assert_array_equal(c, rgb)
    other = str(tmp_path / "y.ply")
    (jax_write_ply if writer == "port" else write_ply)(other, xyz, rgb)
    assert open(path, "rb").read() == open(other, "rb").read()


def test_spill_cache_roundtrip(tmp_path):
    rng = np.random.RandomState(3)
    arrs = {i: rng.randn(64, 64).astype(np.float32) for i in range(8)}
    with SpillCache(max_bytes=3 * arrs[0].nbytes,
                    spill_dir=str(tmp_path)) as c:
        for k, v in arrs.items():
            c[k] = v
        assert c.n_spills > 0
        for k, v in arrs.items():
            assert k in c
            np.testing.assert_array_equal(c[k], v)
        c[2] = arrs[2] * 2
        np.testing.assert_array_equal(c[2], arrs[2] * 2)
        assert len(c) == 8 and c.n_reloads > 0
    assert len(c) == 0


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_evaluate_scan_equals_jax(noise):
    scene = PlaneScene(img_wh=(48, 40), n_views=3, z0=460.0, slope_x=0.3)
    stl = scene.surface_points()
    rng = np.random.RandomState(5)
    data = stl[::2] + rng.randn(len(stl[::2]), 3) * noise
    data = np.concatenate([data, rng.rand(50, 3) * 600])       # outliers
    got = evaluate_scan(data, stl, scan=3, max_dist=20.0)
    want = jax_evaluate_scan(data, stl, scan=3, max_dist=20.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.overall == want.overall and got.n_data > 0
    np.testing.assert_array_equal(reduce_points(data, 0.5, seed=2),
                                  jax_reduce_points(data, 0.5, seed=2))
    assert aggregate([got, got]) == jax_aggregate([want, want])


def test_fused_gt_cloud_scores_exact_on_dtu_benchmark(tmp_path):
    """GT depths of a port tree -> the port's fusion loop and DTU scorer:
    as tests/test_fusion.py's test of the same name for the JAX package."""
    from casmvsnet_pl_tpu_torch.data import DTUDataset, write_dtu_tree
    from casmvsnet_pl_tpu_torch.data import PlaneScene as PortScene
    from casmvsnet_pl_tpu_torch.data.base import load_image

    root = str(tmp_path / "tree")
    write_dtu_tree(root, scans=("synth1",), n_cams=5, lights=(3,))
    lists = str(tmp_path)
    with open(os.path.join(lists, "test.txt"), "w") as f:
        f.write("synth1\n")

    class Tiny(DTUDataset):
        NATIVE_WH = (256, 256)
        N_CAMS = 5
        LISTS_DIR = lists

    ds = Tiny(root, "test", n_views=3, img_wh=(64, 64))
    scene = PortScene(img_wh=(64, 64), n_views=5, z0=460.0, slope_x=0.3)
    metas = [(m[2], m[3]) for m in ds.metas]
    ply = str(tmp_path / "gt.ply")
    n = fuse_and_write(
        ply, metas,
        lambda vid: load_image(os.path.join(
            root, f"Rectified/synth1/rect_{vid + 1:03d}_3_r5000.png")),
        lambda vid: scene.depth_map(vid),
        lambda vid: np.ones((16, 16), np.float32),
        lambda vid: ds.proj_mats[vid][0][0], (64, 64),
        conf=0.5, min_geo_consistent=2, cache_bytes=None, device="cpu")
    assert n > 10_000
    xyz, _ = read_ply(ply)
    res = evaluate_scan(xyz, scene.surface_points(), max_dist=20.0)
    assert res.mean_acc < 0.1, res
    assert res.median_comp < 0.1, res
    assert res.overall < 0.5, res
