"""The FMT's layer kernels in the benchmark: their bound
(``counts/fmt_layer.py``) worked by hand at the eval shape, and
``fmt_roofline`` read over every kernel of ``csrc/fmt_layer.cu`` and
silent where none ran."""
from __future__ import annotations

import os
import re

import pytest

from perfbench import harness
from perfbench.architectures.transmvsnet import fmt_flops
from perfbench.counts.fmt_layer import fmt_bound_s, fmt_layers, layer_work
from perfbench.harness import ROOT, load_json

CFG = load_json("configs", "transmvsnet.json")
EVAL = ((1152, 864), 5, 1)
TOKENS = 216 * 288      # the 1/4 level of 1152 x 864


def _metric():
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", "fmt_roofline.py"), "fmt_rl")


def test_the_bound_is_worked_by_hand_at_the_eval_shape():
    """Self layers over n = s = 5 x 62,208 tokens, cross layers over
    n = 4 x 62,208 against s = 62,208; 64 bytes a token (32 bf16 values):
    a self layer moves 2 n, a cross layer 2 n + s tokens, 302.6 MB in all.
    The 43.9 GFLOP of ``fmt_flops`` split: 16 n d^2 + 4 s d^2 a layer on
    the tensor cores, 2 (s + n) d d_h + 2 n d on the CUDA cores. Every
    layer is bound by its bytes."""
    n, m = 5 * TOKENS, 4 * TOKENS
    layers = fmt_layers(CFG, *EVAL)
    assert layers == [(n, n, False), (m, TOKENS, True)] * 4
    work = [layer_work(a, s, 32, 8, c) for a, s, c in layers]
    assert work[0] == (2 * n * 64, 2 * n * 128 + 2 * n * 128 + 2 * n * 32,
                       20 * n * 1024)
    assert work[1] == ((2 * m + TOKENS) * 64,
                       2 * TOKENS * 128 + 2 * m * 128 + 2 * m * 32,
                       16 * m * 1024 + 4 * TOKENS * 1024)
    nbytes, cuda, tensor = (sum(w[i] for w in work) for i in range(3))
    assert nbytes == 302_579_712
    assert (cuda, tensor) == (1_098_842_112, 42_807_066_624)
    assert cuda + tensor == fmt_flops(5, 1, TOKENS, 32, 8, 4) \
        == 43_905_908_736
    for b, c, t in work:
        assert b / 3.35e12 > max(c / 67e12, t / 989e12)
    assert fmt_bound_s(CFG, *EVAL) == pytest.approx(302_579_712 / 3.35e12,
                                                    rel=1e-12)


def test_fmt_roofline_reads_every_kernel_of_the_fmt_layer():
    """Each ``__global__`` function of ``csrc/fmt_layer.cu`` (the reduction
    and the pass) is among the kernels ``fmt_roofline`` times: a kernel it
    missed would leave its share out of the time a map."""
    src = os.path.join(ROOT, "casmvsnet_pl_tpu_torch", "csrc",
                       "fmt_layer.cu")
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                       r"(\w+)\(", open(src).read())
    assert sorted(names) == ["fmt_layer_apply_kernel", "fmt_layer_kv_kernel"]
    kernels = {f"void (anonymous namespace)::{k}<__nv_bfloat16>(...)":
               (16, 2e-4) for k in names}
    kernels["void (anonymous namespace)::deform_conv_kernel<0>(...)"] = (
        9, 1.0)
    run = {"trace": {"kernels": kernels}, "config": CFG, "units": 2,
           "img_wh": (1152, 864), "mix": {"n_views": 5, "batch": 1}}
    assert _metric().read(run) == pytest.approx(
        100 * fmt_bound_s(CFG, *EVAL) / (len(names) * 2e-4 / 2))


@pytest.mark.parametrize("config", ["transmvsnet", "casmvsnet"])
def test_fmt_roofline_is_silent_without_the_kernels(config):
    """A program without the FMT's kernels (the FMT in PyTorch operators)
    and a configuration without an FMT read None."""
    kernels = {"void at::native::vectorized_layer_norm_kernel<...>": (
        16, 0.2), "void (anonymous namespace)::cost_volume_kernel<0>(...)": (
        3, 0.01)}
    run = {"trace": {"kernels": kernels},
           "config": load_json("configs", f"{config}.json"), "units": 2,
           "img_wh": (1152, 864), "mix": {"n_views": 5, "batch": 1}}
    assert _metric().read(run) is None
