"""The ``transmvsnet`` configuration and its cell
``transmvsnet.eval_1152x864x5``: the cell run through ``harness.run_cell``
on the CPU at a small size with ``correct`` true; the architecture's FLOP
count and the deformable conv's bound pinned to values worked by hand; the
roofline read over every form of the kernel; the seed's weights pinned;
the offsets that ``drawn`` gives at unit-scale input; the launch checks."""
from __future__ import annotations

import hashlib
import os
import re

import pytest
import torch

from perfbench import compare, harness, program
from perfbench.architectures import casmvsnet
from perfbench.counts import flops, roofline
from perfbench.counts.deform_conv import arf_bound_s, dcn_bound_s, \
    dcn_work
from perfbench.harness import ROOT, architecture, load_json

CELL = "transmvsnet.eval_1152x864x5"
CFG = load_json("configs", "transmvsnet.json")
DIGESTS = {
    0: "1bdce21eae72ad27295d86cd749d71793fb624cfd0acc8e3eb31bb607d10e3ac",
    1: "0461f4e99dbe0bffc2ba0669dba368774a81b51cae22ac2f1eaf35f9afcaa2b4",
}
DRAWN = 116         # 46 of CasMVSNet's shape, 18 ARF, 48 FMT Linear, 4 pathway


def test_the_cell_runs_on_the_cpu_and_is_correct():
    r = harness.run_cell(CELL, [3_000_000_023], 0.3, False,
                         torch.device("cpu"), size=(64, 64))[0]
    assert compare.passed(r["checks"]), r["checks"]
    assert r["attempted"] > 0
    assert set(r["checks"]) == {k for k in load_json(
        "workloads", f"{CELL}.json")["limits"] if not k.endswith("_gap")}


def test_a_planted_fault_is_not_correct():
    r = harness.run_cell(CELL, [3_000_000_023], 0.3, False,
                         torch.device("cpu"), fault="altered",
                         size=(64, 64))[0]
    assert not compare.passed(r["checks"])


def test_the_flop_count_is_worked_by_hand():
    """At 64x32, 3 views, B=1 (N = 3 images): the trunk, CostRegNets and
    cost volume by the frozen counts CasMVSNet's share, and by hand the
    ARF (per level, 3 x (offset conv 2 N h w 9 27 C + contraction
    2 N h w 9 C^2)), the FMT (4 blocks of a self layer over n = 384 tokens
    and a cross layer over n = 256 against s = 128, d = 32, d_h = 4) and
    the pathway's four convolutions."""
    arch = architecture(CFG)
    ref = arch.reference(CFG)
    W, H, N = 64, 32, 3
    arf = 3 * (2 * 6144 * 9 * 27 * 8 + 2 * 6144 * 9 * 64) \
        + 3 * (2 * 1536 * 9 * 27 * 16 + 2 * 1536 * 9 * 256) \
        + 3 * (2 * 384 * 9 * 27 * 32 + 2 * 384 * 9 * 1024)
    assert arf == 189_112_320
    self_layer = 16 * 384 * 1024 + 4 * 384 * 1024 + 2 * 32 * 4 * 768 \
        + 2 * 384 * 32
    cross_layer = 16 * 256 * 1024 + 4 * 128 * 1024 + 2 * 32 * 4 * 384 \
        + 2 * 256 * 32
    assert (self_layer, cross_layer) == (8_085_504, 4_833_280)
    fmt = 4 * (self_layer + cross_layer)
    pathway = 2 * 3 * 128 * 16 * 32 + 2 * 3 * 512 * 9 * 256 \
        + 2 * 3 * 512 * 16 * 8 + 2 * 3 * 2048 * 9 * 64
    assert pathway == 14_942_208
    shared = flops.net_flops(ref.feature, casmvsnet.FEATURE_INPUTS, N, (H, W),
                             False)
    for l, D in enumerate(CFG["n_depths"]):
        shared += flops.net_flops(getattr(ref, f"cost_reg_{l}"),
                                  casmvsnet.COST_REG_INPUTS, 1,
                                  (D, H >> l, W >> l), False)
    shared += flops.cost_volume_flops(CFG["n_depths"], (8, 16, 32), (W, H), 3,
                                      1, "groupwise")
    assert arch.flops(CFG, (W, H), 3, 1) == shared + arf + fmt + pathway \
        == 645_009_408
    # the cell's shape, pinned
    assert arch.flops(CFG, (1152, 864), 5, 1) == 439_449_255_936
    with pytest.raises(ValueError):
        arch.flops(CFG, (W, H), 3, 1, train=True)


def test_the_deformable_bound_is_worked_by_hand():
    """Level 0 at 1152x864x5: n = 4,976,640 pixels of 8 channels; bytes
    (8 + 27 + 8) n + 9 x 64 weights, 2 bytes each; operations
    (18 x 64 + 81 x 8) n on the CUDA cores. Levels 1 and 2 (16 and 32
    channels) contract on the tensor cores: their 81 C n sampling
    operations stay on the CUDA cores, their 18 C^2 n go to the tensor
    cores, and their bytes bound them."""
    n = 5 * 864 * 1152
    assert dcn_work(5, 864, 1152, 8) == ((43 * n + 576) * 2, 1800 * n, 0) \
        == (427_992_192, 8_957_952_000, 0)
    assert dcn_work(5, 432, 576, 16) == (
        (59 * n // 4 + 9 * 256) * 2, 1296 * n // 4, 4608 * n // 4) \
        == (146_815_488, 1_612_431_360, 5_733_089_280)
    assert dcn_work(5, 216, 288, 32) == (
        (91 * n // 16 + 9 * 1024) * 2, 2592 * n // 16, 18432 * n // 16) \
        == (56_627_712, 806_215_680, 5_733_089_280)
    # float32, or bf16 at C = 8: everything on the CUDA cores
    assert dcn_work(5, 216, 288, 32, 4) == (
        113_255_424, 806_215_680 + 5_733_089_280, 0)
    assert dcn_bound_s(5, 864, 1152, 8) == (8_957_952_000 / 67e12,
                                            "operations")
    assert dcn_bound_s(5, 432, 576, 16) == (146_815_488 / 3.35e12, "bytes")
    assert dcn_bound_s(5, 216, 288, 32) == (56_627_712 / 3.35e12, "bytes")
    least = 8_957_952_000 / 67e12 + (146_815_488 + 56_627_712) / 3.35e12
    assert arf_bound_s(CFG, (1152, 864), 5, 1) == pytest.approx(
        3 * least, rel=1e-12)
    assert arf_bound_s(CFG, (1152, 864), 5, 1) == pytest.approx(
        5.8329027e-4, rel=1e-7)
    # K1 counted as the one-group correlation
    assert roofline.cascade_bound_s(CFG, (1152, 864), 5, 1) == \
        0.00020815725277611942


def test_arf_roofline_reads_every_kernel_of_the_deformable_conv():
    """Each ``__global__`` function of ``csrc/deform_conv.cu`` (the CUDA-core
    and the tensor-core form) is among the kernels ``arf_roofline`` times:
    a form it missed would leave its levels out of the time a map."""
    src = os.path.join(ROOT, "casmvsnet_pl_tpu_torch", "csrc",
                       "deform_conv.cu")
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                       r"(\w+)\(", open(src).read())
    assert sorted(names) == ["deform_conv_kernel", "deform_conv_kernel_mma"]
    kernels = {f"void (anonymous namespace)::{k}<{i}>(...)": (3, 1e-3)
               for i, k in enumerate(names)}
    kernels["void (anonymous namespace)::cost_volume_kernel<0>(...)"] = (
        3, 1.0)
    run = {"trace": {"kernels": kernels}, "config": CFG, "units": 2,
           "img_wh": (1152, 864), "mix": {"n_views": 5, "batch": 1}}
    metric = harness.load_module(
        os.path.join(harness.HERE, "metrics", "arf_roofline.py"), "arf_rl")
    assert metric.read(run) == pytest.approx(
        100 * arf_bound_s(CFG, (1152, 864), 5, 1) / (len(names) * 1e-3 / 2))


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_the_seeds_weights_are_pinned(seed):
    arch = architecture(CFG)
    keys = [k for k, _ in arch.drawn(arch.reference(CFG))]
    state = program.draw_weights(CFG, seed, "cpu")
    assert len(keys) == DRAWN
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[seed]
    for k, v in state.items():
        if k.endswith("bias") and "norm" not in k and ".bn" not in k:
            assert not v.any(), k


@pytest.mark.parametrize("seed", [2, 3_000_000_029])
def test_the_offsets_are_about_a_pixel_at_unit_scale_input(seed):
    """Each of the nine ``conv_offset_mask`` convs, drawn at deviation
    1 / sqrt(9 C), gives offsets of RMS 0.9-1.1 px on unit-normal input,
    and masks spread over (0, 1)."""
    arch = architecture(CFG)
    ref = arch.reference(CFG)
    ref.load_state_dict(program.draw_weights(CFG, seed, "cpu"))
    g = torch.Generator().manual_seed(seed % 2 ** 31)
    with torch.no_grad():
        for l, C in enumerate((8, 16, 32)):
            for i in range(3):
                conv = getattr(ref.arf[l], f"dcn{i}").conv_offset_mask
                om = conv(torch.randn((1, C, 48, 48), generator=g))
                rms = float(om[:, :18].pow(2).mean().sqrt())
                assert 0.9 < rms < 1.1, (l, i, rms)
                mask = torch.sigmoid(om[:, 18:])
                assert mask.min() < 0.2 and mask.max() > 0.8


def test_the_launch_checks_are_pinned():
    arch = architecture(CFG)
    assert arch.launch_checks(CFG, train=False) == {
        "k1_launch_gap": ("cost_volume_cuda", 3),
        "dcn_launch_gap": ("deform_conv_cuda", 9)}
    with pytest.raises(ValueError):
        arch.launch_checks(CFG, train=True)
