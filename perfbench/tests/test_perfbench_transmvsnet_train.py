"""The ``transmvsnet_train`` configuration and its cell
``transmvsnet_train.train_640x512x5_b2``: the cell run through
``harness.run_cell`` on the CPU at a small size with ``correct`` true, and
false with a planted fault; the traffic kind's centres and its control;
the architecture's count of a training step and its launch checks; the
deformable backward's bound (``counts/deform_conv_bwd.py``) worked by
hand; the two metrics this cell adds; the configuration against
``transmvsnet``'s."""
from __future__ import annotations

import os
import re

import pytest
import torch

from perfbench import compare, harness, program
from perfbench.architectures import transmvsnet
from perfbench.counts import flops
from perfbench.counts.deform_conv_bwd import (arf_bwd_bound_s,
                                              dcn_bwd_bound_s, dcn_bwd_work)
from perfbench.harness import ROOT, architecture, load_cell, load_json
from perfbench.traffic import focal_steps

CELL = "transmvsnet_train.train_640x512x5_b2"
CFG = load_json("configs", "transmvsnet_train.json")
EVAL_CFG = load_json("configs", "transmvsnet.json")
SEED = 3_000_000_031


def test_the_configuration_is_transmvsnets_with_its_training():
    """Every key of ``transmvsnet`` at the same value (the widths), but the
    name, the architecture's file, the source and the ``assumed`` list,
    which keeps every entry of ``transmvsnet``'s; the training keys of the
    other training cells' configurations."""
    for k, v in EVAL_CFG.items():
        if k in ("name", "arch", "source", "assumed"):
            continue
        assert CFG[k] == v, k
    assert CFG["reduced"] == []
    assert set(EVAL_CFG["assumed"]) < set(CFG["assumed"])
    casmvsnet = load_json("configs", "casmvsnet.json")
    for k in ("optimizer", "lr", "weight_decay"):
        assert CFG[k] == casmvsnet[k], k
    assert (CFG["loss"], CFG["gamma"]) == ("focal", 2.0)
    assert len(CFG["source"]) <= 200
    # the same drawn weights as the eval configuration's
    a = program.draw_weights(CFG, 7, "cpu")
    b = program.draw_weights(EVAL_CFG, 7, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_the_cell_runs_on_the_cpu_and_is_correct():
    r = harness.run_cell(CELL, [SEED], 0.3, False, torch.device("cpu"),
                         size=(64, 64))[0]
    assert compare.passed(r["checks"]), r["checks"]
    assert r["attempted"] > 0
    limits = load_json("workloads", f"{CELL}.json")["limits"]
    assert set(r["checks"]) == {k for k in limits
                                if not k.endswith("launch_gap")}
    assert set(r["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}


def test_a_planted_fault_is_not_correct(monkeypatch):
    """A step that leaves the state unchanged reads a change gap of 1 (the
    fault patches the trainer in this process: undone after the test)."""
    from casmvsnet_pl_tpu_torch.engine.trainer import MVSTrainer
    monkeypatch.setattr(MVSTrainer, "train_step", MVSTrainer.train_step)
    r = harness.run_cell(CELL, [SEED], 0.3, False, torch.device("cpu"),
                         fault="unchanged", size=(64, 64))[0]
    assert r["numbers"]["change_gap"] == 1.0
    assert not compare.passed(r["checks"])


def test_the_control_runs_through_run_cell():
    """``readings.py --mode control`` runs a cell through ``run_cell`` unless
    its kind's name starts with ``train_steps``: this kind answers the
    control mode with its references alone, and the control is not correct
    (its volumes several times as far from the reference's as bf16's)."""
    cell, cfg, mix = load_cell(CELL)
    assert not mix["kind"].startswith("train_steps")
    (r,) = harness.run_cell(CELL, [SEED], 0.0, False, torch.device("cpu"),
                            mode="control", size=(64, 64))
    assert set(r["numbers"]) == {"loss_gap", "grad_gap_median",
                                 "change_gap", "grad_gap_worst",
                                 "volume_vs_bf16", "wta_gap", "wta_led"}
    assert r["numbers"]["grad_gap_median"] > 0
    table = compare.checks(r["numbers"], cell["limits"], cuda=False)
    assert not compare.passed(table), table


def test_the_focal_numbers_read_the_volumes_and_the_winners():
    """Volumes equal to the reference's read 0 whatever bf16's gap, twice
    bf16's difference reads 2, and a half batch compares its first scene;
    depths one spacing off read a ``wta_gap`` of 1 over the clearly led
    pixels, and a pixel led by less than ``LEAD`` is not counted."""
    g = torch.Generator().manual_seed(0)
    vol = {l: torch.randn((2, 4, 3, 5), generator=g) for l in range(3)}
    noise = {l: torch.randn((2, 4, 3, 5), generator=g) for l in range(3)}
    bf16 = {l: vol[l] + 0.01 * noise[l] for l in range(3)}
    depth = {l: 500 + 100 * torch.rand((2, 3, 5), generator=g)
             for l in (1, 2)}
    lead = {l: torch.full((2, 3, 5), 2 * focal_steps.LEAD) for l in (1, 2)}
    lead[1][0, 0, 0] = 0.5 * focal_steps.LEAD
    step = torch.full((2, 3, 5), 4.0)
    ref = {"volumes": vol,
           "wta": {l: (depth[l], lead[l], step) for l in (1, 2)}}
    n = focal_steps.focal_numbers(ref, depth, vol, bf16)
    assert n == {"volume_vs_bf16": 0.0, "wta_gap": 0.0, "wta_led": 59 / 60}
    twice = {l: vol[l] + 0.02 * noise[l] for l in range(3)}
    assert focal_steps.focal_numbers(ref, depth, twice, bf16)[
        "volume_vs_bf16"] == pytest.approx(2.0, rel=1e-6)
    half = {l: v[:1] for l, v in vol.items()}
    assert focal_steps.focal_numbers(ref, depth, half, bf16)[
        "volume_vs_bf16"] == 0.0
    off = {l: d + step for l, d in depth.items()}
    assert focal_steps.focal_numbers(ref, off, vol, bf16)["wta_gap"] == 1.0
    near = {l: d + 0.4 * step for l, d in depth.items()}
    assert focal_steps.focal_numbers(ref, near, vol, bf16)["wta_gap"] == 0.0


def test_the_centres_are_taken_by_step_and_level():
    """Three levels recorded coarse to fine, two steps: each step's depths
    of levels 2 and 1, the levels whose depth centres a finer window."""
    seen = [torch.full((1,), float(i)) for i in range(6)]
    got = focal_steps.step_centres(seen, 3)
    assert [{k: float(v) for k, v in c.items()} for c in got] == [
        {2: 0.0, 1: 1.0}, {2: 3.0, 1: 4.0}]


def test_the_training_count_is_the_forward_three_times():
    """A training step counts every operation of the forward three times
    but the images' first convolution (twice: its input takes no gradient)
    and the cost volumes (forward and K2's backward); the cell's shape
    pinned."""
    arch = architecture(CFG)
    ref = arch.reference(CFG)
    W, H, views, batch = 64, 32, 3, 2
    first = flops._one_conv(ref.feature.conv0[0].conv, batch * views, (H, W))
    fwd_cv = flops.cost_volume_flops(CFG["n_depths"], (8, 16, 32), (W, H),
                                     views, batch, "groupwise")
    train_cv = flops.cost_volume_flops(CFG["n_depths"], (8, 16, 32), (W, H),
                                       views, batch, "groupwise",
                                       backward=True)
    fwd = transmvsnet.flops(EVAL_CFG, (W, H), views, batch)
    assert arch.flops(CFG, (W, H), views, batch) == fwd
    assert arch.flops(CFG, (W, H), views, batch, train=True) == \
        3 * (fwd - fwd_cv) - first + train_cv
    assert arch.flops(CFG, (640, 512), 5, 2, train=True) == 854_306_324_480


def test_the_launch_checks_are_pinned():
    arch = architecture(CFG)
    assert arch.launch_checks(CFG, train=True) == {
        "k1_launch_gap": ("cost_volume_cuda", 3),
        "k2_launch_gap": ("cost_volume_bwd_cuda", 3),
        "dcn_launch_gap": ("deform_conv_cuda", 9),
        "dcn_bwd_launch_gap": ("deform_conv_bwd_cuda", 9)}
    assert arch.launch_checks(CFG, train=False) == \
        transmvsnet.launch_checks(EVAL_CFG, False)
    limits = load_json("workloads", f"{CELL}.json")["limits"]
    assert {k for k in limits if k.endswith("launch_gap")} == \
        set(arch.launch_checks(CFG, train=True))


def test_the_backward_bound_is_worked_by_hand():
    """Level 0 of the cell: n = 10 x 512 x 640 pixels of 8 channels; bytes
    (2 x 8 + 2 x 27) n at 2 bytes, 8 n at 4 (the float32 input gradient)
    and 9 x 64 weights at 2 + 4; operations (36 x 64 + 144 x 8) n on the
    CUDA cores. At 16 and 32 channels the contractions (36 C^2 n) are
    priced at the tensor cores' rate, as the forward's are, and levels 1
    and 2 are bound by their bytes."""
    n = 10 * 512 * 640
    assert dcn_bwd_work(10, 512, 640, 8) == (
        70 * 2 * n + 32 * n + 576 * 6, 3456 * n, 0) == (
        563_613_056, 11_324_620_800, 0)
    assert dcn_bwd_bound_s(10, 512, 640, 8) == (11_324_620_800 / 67e12,
                                                "operations")
    assert dcn_bwd_work(10, 256, 320, 16) == (
        (86 * 2 + 16 * 4) * n // 4 + 2304 * 6, 2304 * n // 4,
        9216 * n // 4) == (193_345_024, 1_887_436_800, 7_549_747_200)
    assert dcn_bwd_bound_s(10, 256, 320, 16) == (193_345_024 / 3.35e12,
                                                 "bytes")
    assert dcn_bwd_work(10, 128, 160, 32) == (
        (118 * 2 + 32 * 4) * n // 16 + 9216 * 6, 4608 * n // 16,
        36864 * n // 16)
    assert dcn_bwd_bound_s(10, 128, 160, 32)[1] == "bytes"
    # float32 operands: every operation on the CUDA cores
    assert dcn_bwd_work(10, 128, 160, 32, 4)[1:] == (41472 * n // 16, 0)
    least = sum(dcn_bwd_bound_s(10, 512 >> l, 640 >> l, C)[0]
                for l, C in enumerate((8, 16, 32)))
    assert least == pytest.approx(1.69e-4 + 5.77e-5 + 2.23e-5, rel=3e-3)
    assert arf_bwd_bound_s(CFG, (640, 512), 5, 2) == pytest.approx(
        3 * least, rel=1e-12)


def test_arf_bwd_roofline_reads_the_backward_kernel_alone():
    """``csrc/deform_conv_bwd.cu``'s one ``__global__`` function is what
    the metric times; the forward's kernels are ``arf_roofline``'s."""
    src = os.path.join(ROOT, "casmvsnet_pl_tpu_torch", "csrc",
                       "deform_conv_bwd.cu")
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                       r"(\w+)\(", open(src).read())
    assert names == ["deform_conv_bwd_kernel"]
    kernels = {
        "void (anonymous namespace)::deform_conv_bwd_kernel<bf16, 8>(...)":
            (6, 4e-3),
        "void (anonymous namespace)::deform_conv_kernel<bf16, 8>(...)":
            (6, 1.0),
        "void (anonymous namespace)::deform_conv_kernel_mma<32>(...)":
            (6, 1.0)}
    run = {"trace": {"kernels": kernels}, "config": CFG, "units": 2,
           "img_wh": (640, 512), "mix": {"n_views": 5, "batch": 2}}
    metric = harness.load_module(
        os.path.join(harness.HERE, "metrics", "arf_bwd_roofline.py"), "abr")
    assert metric.read(run) == pytest.approx(
        100 * arf_bwd_bound_s(CFG, (640, 512), 5, 2) / 2e-3)
    run["trace"]["kernels"] = {k: v for k, v in kernels.items()
                               if "bwd" not in k}
    assert metric.read(run) is None


def test_arf_bwd_ms_reads_the_span():
    from casmvsnet_pl_tpu_torch.ops.deform_conv import _DeformConv
    import inspect
    assert '"arf.backward"' in inspect.getsource(_DeformConv.backward)
    metric = harness.load_module(
        os.path.join(harness.HERE, "metrics", "arf_bwd_ms.train.py"), "abm")
    assert metric.read({"units": 1}) is None     # no record, no value


@pytest.mark.cuda
def test_the_control_is_not_correct(card):
    """The fp8 control against the cell's own limits, at 320x256."""
    cell, cfg, mix = load_cell(CELL)
    for seed in (11, 2200000000, 33):
        ctx = harness.Ctx(CELL, cell, cfg, mix, [seed], 0.0, False, card,
                          0.0, "control", size=(320, 256))
        table = compare.checks(focal_steps.control_numbers(ctx, seed),
                               cell["limits"], cuda=False)
        assert not compare.passed(table), table
