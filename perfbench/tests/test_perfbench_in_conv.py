"""CostRegNet's one-channel input block in the benchmark: its bound
(``counts/in_conv.py``) worked by hand at the eval shape, and
``in_conv_roofline`` read over the kernel of ``csrc/in_conv.cu`` and
silent where it did not run."""
from __future__ import annotations

import os
import re

import pytest

from perfbench import harness
from perfbench.counts.in_conv import (in_conv_bound_s, in_conv_work,
                                      map_bound_s, one_channel)
from perfbench.harness import ROOT, load_json

CFG = load_json("configs", "transmvsnet.json")
EVAL_WH = (1152, 864)
KERNEL = "void (anonymous namespace)::in_conv_kernel<__nv_bfloat16, " \
    "__nv_bfloat16>(...)"


def _metric():
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", "in_conv_roofline.py"),
        "in_conv_rl")


def _run(config, kernels, units=2):
    return {"trace": {"kernels": kernels}, "config": config, "units": units,
            "img_wh": EVAL_WH, "mix": {"n_views": 5, "batch": 1}}


def test_the_bound_is_worked_by_hand_at_the_eval_shape():
    """Levels of 8 x 864 x 1152, 32 x 432 x 576 and 48 x 216 x 288 voxels:
    18,911,232 in all, 2 bytes in and 16 out and 432 operations each,
    340.4 MB and 8.17 GFLOP. Every level is bound by its bytes, in bf16 on
    the tensor cores and in float32 (36 bytes a voxel) on the CUDA cores
    alike."""
    levels = [(D, 864 >> l, 1152 >> l) for l, D in enumerate(CFG["n_depths"])]
    assert levels == [(8, 864, 1152), (32, 432, 576), (48, 216, 288)]
    work = [in_conv_work(1, *lv) for lv in levels]
    voxels = sum(D * h * w for D, h, w in levels)
    assert voxels == 18_911_232
    assert sum(b for b, _ in work) == 18 * voxels == 340_402_176
    assert sum(o for _, o in work) == 432 * voxels == 8_169_652_224
    for lv in levels:
        for itemsize in (2, 4):
            assert in_conv_bound_s(1, *lv, itemsize)[1] == "bytes"
    assert map_bound_s(CFG, EVAL_WH, 1) == pytest.approx(
        340_402_176 / 3.35e12, rel=1e-12)
    assert 1e3 * map_bound_s(CFG, EVAL_WH, 1) == pytest.approx(0.1016,
                                                               abs=1e-4)


def test_in_conv_roofline_reads_the_kernel_of_in_conv_cu():
    """The ``__global__`` function of ``csrc/in_conv.cu`` is the kernel
    that ``in_conv_roofline`` times, a map: three launches of 0.1 ms each
    a map over 2 maps read the bound over 0.3 ms; other kernels, cuDNN's
    conv among them, are not counted."""
    src = os.path.join(ROOT, "casmvsnet_pl_tpu_torch", "csrc", "in_conv.cu")
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                       r"(\w+)\(", open(src).read())
    assert names == ["in_conv_kernel"]
    kernels = {KERNEL: (6, 6e-4),
               "void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, "
               "5, 3, 3, 3, 1, false, false, true>(...)": (6, 7e-3),
               "void (anonymous namespace)::prob_conv_kernel<__nv_bfloat16>"
               "(...)": (6, 1e-3)}
    assert _metric().read(_run(CFG, kernels)) == pytest.approx(
        100 * map_bound_s(CFG, EVAL_WH, 1) / 3e-4)


@pytest.mark.parametrize("config", ["transmvsnet", "casmvsnet",
                                    "casmvsnet_gwc8"])
def test_in_conv_roofline_is_silent_without_the_kernel(config):
    """A program that runs the block in cuDNN reads None, and so does a
    configuration whose volume has more than one channel."""
    cfg = load_json("configs", f"{config}.json")
    assert one_channel(cfg) == (config == "transmvsnet")
    kernels = {"void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, "
               "5, 3, 3, 3, 1, false, false, true>(...)": (6, 7e-3),
               "void (anonymous namespace)::cost_volume_kernel<0>(...)": (
                   6, 0.01)}
    assert _metric().read(_run(cfg, kernels)) is None
    if config != "transmvsnet":
        assert _metric().read(_run(cfg, {KERNEL: (6, 6e-4)})) is None
