"""``evaluations/dtu/eval_dtu_torch.py`` against ``eval_dtu.py``, and
``chip_smoke.py``'s training-quality path (phases 49-50) rehearsed on the
CPU.

Both scoring CLIs read the same PLYs (the plane scene's closed-form
surface as the ground truth; as the cloud, that surface exactly, with
σ = 0.3 noise, and the noisy cloud written as an ASCII PLY, which both read
through their fallback) and must write the same JSON, within 1e-12
relative.

The rehearsal runs phases 49-50 with the kernels' plain versions standing
in for K1/K2 and the ``prob`` conv's kernel (each counts its launches, as
the wrappers do) and a 1-epoch
fit in f32: the exact launch counts, the CPU reference against the stubbed
"card" fit, the checkpoints and events, the eval of the fitted model and
the scoring subprocess. A 1-epoch fit does not reach the 4-epoch bar (its
val abs_err is ~39 mm), so the rehearsal sets thresholds and cloud bounds
that only say the numbers exist; the bar itself is held on the CPU by
tests/test_torch_port_quality.py and on the card by phases 49-50.
"""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
import eval_torch
from casmvsnet_pl_tpu_torch import kernels
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.engine import convergence
from casmvsnet_pl_tpu_torch.fusion import write_ply
from casmvsnet_pl_tpu_torch.kernels.cost_volume import (CostVolumeBwdKernel,
                                                        CostVolumeKernel)
from casmvsnet_pl_tpu_torch.kernels.prob_conv import ProbConvKernel
from casmvsnet_pl_tpu_torch.models import cascade, cost_reg
from casmvsnet_pl_tpu_torch.ops import plane_sweep
from casmvsnet_pl_tpu_torch.ops import prob_conv as prob_conv_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-12


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "evaluations", "dtu", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_ascii_ply(path: str, xyz: np.ndarray) -> None:
    """x, y, z and a colour, one vertex a line."""
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(xyz)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for x, y, z in xyz.tolist():
            f.write(f"{x!r} {y!r} {z!r} 128 64 32\n")


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    """scan1: the surface itself; scan2: it with σ = 0.3 noise; scan3: the
    noisy cloud as an ASCII PLY; every scan's ground truth the surface."""
    d = tmp_path_factory.mktemp("plys")
    stl = PlaneScene(img_wh=(64, 64), n_views=5, z0=460.0,
                     slope_x=0.3).surface_points()
    noisy = stl + np.random.RandomState(0).normal(0.0, 0.3, stl.shape)
    colour = np.zeros(stl.shape, np.uint8)
    write_ply(str(d / "scan1.ply"), stl, colour)
    write_ply(str(d / "scan2.ply"), noisy, colour)
    write_ascii_ply(str(d / "scan3.ply"), noisy.astype(np.float32))
    for scan in (1, 2, 3):
        write_ply(str(d / f"stl{scan:03d}_total.ply"), stl, colour)
    return str(d)


def _assert_json_equal(got, want, path="") -> None:
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_json_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_equal(g, w, f"{path}/{i}")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL_TOL, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, path


@pytest.mark.parametrize("scans", [["1"], ["2"], ["3"], ["1", "2", "3"]])
def test_eval_dtu_torch_json_equals_eval_dtu(plys, tmp_path, capsys, scans):
    out = {}
    for name in ("eval_dtu", "eval_dtu_torch"):
        path = str(tmp_path / f"{name}.json")
        _load(name).main(["--ply_dir", plys, "--gt_dir", plys, "--scans",
                          *scans, "--out_json", path])
        with open(path) as f:
            out[name] = json.load(f)
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert printed[:half] == printed[half:]     # the same printout
    _assert_json_equal(out["eval_dtu_torch"], out["eval_dtu"])
    agg = out["eval_dtu_torch"]["aggregate"]
    if scans == ["1"]:
        assert agg["overall"] < 0.01    # the 0.2 mm downsampling's share
    else:
        assert 0.1 < agg["mean_acc"] < 1.0      # σ = 0.3: about 0.48


def _counting(plain):
    def call(self, *args):
        self.launches += 1
        return plain(*args)
    return call


def _kernel_route(feats, proj_mats, depth_values, groups=1, sampling="auto"):
    """``build_cost_volume``'s card route on the CPU: K1/K2's autograd
    Function, whose wrappers here run the plain versions."""
    assert sampling == "auto"
    return plane_sweep._CostVolume.apply(feats, proj_mats, depth_values,
                                         groups)


def _prob_conv_route(x, weight, bias):
    """``prob_conv``'s card route on the CPU: its autograd Function, whose
    wrapper here runs the plain version."""
    return prob_conv_op._ProbConv.apply(x, weight, bias)


def test_chip_smoke_quality_phases_rehearse_on_cpu(monkeypatch, capsys):
    """Phases 49-50 end to end on the CPU: a 1-epoch fit in f32 (one seed
    of the spread), K1/K2 and the prob conv's kernel stubbed by their plain
    versions with launch counts, the eval and scoring of the fitted
    model."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name, value in (("DEVICE", "cpu"), ("QUALITY_EPOCHS", 1),
                        ("QUALITY_DTYPE", torch.float32),
                        ("QUALITY_SEEDS", (1,)),
                        ("CLOUD_FLAGS", ("--conf", "0.0",
                                         "--min_geo_consistent", "1")),
                        ("CLOUD_MM", 1e9), ("CLOUD_MIN_POINTS", 0),
                        ("CLOUD_MIN_STL", 0)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(convergence, "THRESHOLDS", {
        "before_abs_err": 8.0, "abs_err": 1e9, "acc_2mm": -1.0})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(eval_torch, "resolve_device",
                        lambda args: torch.device("cpu"))
    monkeypatch.setattr(CostVolumeKernel, "__call__",
                        _counting(plane_sweep.plain_cost_volume))
    monkeypatch.setattr(CostVolumeBwdKernel, "__call__",
                        _counting(plane_sweep.plain_cost_volume_bwd))
    monkeypatch.setattr(cascade, "build_cost_volume", _kernel_route)
    monkeypatch.setattr(ProbConvKernel, "__call__",
                        _counting(prob_conv_op.plain_prob_conv))
    monkeypatch.setattr(cost_reg, "prob_conv", _prob_conv_route)
    cwd = os.getcwd()
    try:
        paths = chip_smoke.quality_path("cpu rehearsal")
    finally:
        torch.set_num_threads(threads)
    assert os.getcwd() == cwd
    # 8 steps, 3 val batches before, after the epoch and after the fit,
    # one train panel (phase 49's fit only); 5 views of 64x64
    none = dict.fromkeys(kernels.launch_counts(), 0)
    assert paths == {
        "quality_fit": {**none, "cost_volume_cuda": 3 * (8 + 3 * 3 + 1),
                        "cost_volume_bwd_cuda": 3 * 8,
                        "prob_conv_cuda": 3 * (8 + 3 * 3 + 1)},
        "quality_fit_jax": {**none, "cost_volume_cuda": 3 * (8 + 3 * 3),
                            "cost_volume_bwd_cuda": 3 * 8,
                            "prob_conv_cuda": 3 * (8 + 3 * 3)},
        "quality_cloud": {**none, "cost_volume_cuda": 3 * 5,
                          "prob_conv_cuda": 3 * 5}}
    out = capsys.readouterr().out
    for what in ("quality fit f32 CPU (one thread, plain cost volume",
                 "quality fit float32 on the card (K1/K2",
                 "quality fit card - CPU abs_err per epoch",
                 "quality fit seed 1 on the card",
                 "on the card from JAX's initial weights",
                 "trained cloud (jax_start):",
                 "trained cloud (init_weights_seed_0):",
                 "eval_dtu_torch.py: acc",
                 "quality path (phases 49-50)"):
        assert what in out, what
