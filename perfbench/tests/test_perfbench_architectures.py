"""What the harness takes from an architecture (``architectures/<arch>.py``),
pinned: the seed's weights (a SHA-256 of the drawn tensors, drawn on the
CPU), the FLOP count that ``mfu.eval`` and ``mfu.train`` read, K1's and
K2's bounds that ``k1_roofline`` and ``k2_roofline`` read, and the launch
checks; and the combine counted from the configuration's ``cost_volume``."""
from __future__ import annotations

import hashlib

import pytest
import torch

from perfbench import compare, program
from perfbench.counts import flops, roofline
from perfbench.harness import architecture, load_json

# SHA-256 of the drawn weights (every convolution weight), drawn on the CPU;
# every other entry of the state is a constant
DIGESTS = {
    ("casmvsnet", 0):
        "9e7dbaa598db7570e9750ff27629c012396f538f30c06eb0817645d3d08fc03b",
    ("casmvsnet", 1):
        "2fd07e7ceff0eef0c9dba76d49eea925b219277176f94894ca4f329b094be871",
    ("casmvsnet_gwc8", 0):
        "1eb9d05554d6fa9e19c66dcc8f2fa025f28a1e476f21fc230874ba9cb94ac29f",
    ("casmvsnet_gwc8", 1):
        "23ae38573ebf578535d8a914f359228d0101934c0e552d6c97d0bd02febc23ae",
}
EVAL, TRAIN = ((1152, 864), 5, 1), ((640, 512), 3, 2)
# (eval forward, training shape forward, training step)
FLOPS = {"casmvsnet": (347930836992, 201671311360, 595925401600),
         "casmvsnet_gwc8": (287446745088, 162223882240, 479470551040)}
# K1 at eval's shape, K1 and K2 at the training shape, seconds
BOUNDS = {"casmvsnet": (0.00024999079737313433, 0.00014398374208955222,
                        0.00017684955701492537),
          "casmvsnet_gwc8": (0.00022669715104477612, 9.810848477611941e-05,
                             0.0001467811343283582)}
CONFIGS = tuple(FLOPS)


def digest(state: dict[str, torch.Tensor], keys) -> str:
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_the_seeds_weights_are_pinned(name, seed):
    cfg = load_json("configs", f"{name}.json")
    arch = architecture(cfg)
    keys = [k for k, _ in arch.drawn(arch.reference(cfg))]
    state = program.draw_weights(cfg, seed, "cpu")
    assert len(keys) == 46
    assert digest(state, keys) == DIGESTS[name, seed]
    for k, v in state.items():
        if k.endswith("bias") and k not in keys:
            assert not v.any(), k


@pytest.mark.parametrize("name", CONFIGS)
def test_the_flop_count_is_pinned(name):
    cfg = load_json("configs", f"{name}.json")
    arch = architecture(cfg)
    assert (arch.flops(cfg, *EVAL), arch.flops(cfg, *TRAIN),
            arch.flops(cfg, *TRAIN, train=True)) == FLOPS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_kernel_bounds_are_pinned(name):
    cfg = load_json("configs", f"{name}.json")
    assert (roofline.cascade_bound_s(cfg, *EVAL),
            roofline.cascade_bound_s(cfg, *TRAIN),
            roofline.cascade_bound_s(cfg, *TRAIN, backward=True)) == \
        BOUNDS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_launch_checks_are_pinned(name):
    cfg = load_json("configs", f"{name}.json")
    arch = architecture(cfg)
    assert arch.launch_checks(cfg, train=False) == {
        "k1_launch_gap": ("cost_volume_cuda", 3)}
    assert arch.launch_checks(cfg, train=True) == {
        "k1_launch_gap": ("cost_volume_cuda", 3),
        "k2_launch_gap": ("cost_volume_bwd_cuda", 3)}


def test_launch_gaps_per_map_or_step():
    checks = {"k1_launch_gap": ("cost_volume_cuda", 3),
              "k2_launch_gap": ("cost_volume_bwd_cuda", 3)}
    before = {"cost_volume_cuda": 5, "cost_volume_bwd_cuda": 2}
    after = {"cost_volume_cuda": 5 + 30, "cost_volume_bwd_cuda": 2 + 25}
    assert compare.launch_gaps(checks, before, after, 10) == {
        "k1_launch_gap": 0.0, "k2_launch_gap": 0.5}
    # a window with no map: the launches themselves
    assert compare.launch_gaps(checks, before, before, 0) == {
        "k1_launch_gap": 3.0, "k2_launch_gap": 3.0}


def test_the_combine_follows_the_cost_volume_not_the_groups():
    """A groupwise correlation at G = 1 (one channel) is counted as a
    correlation: combine 2CS + C, one channel written; a variance of the
    same features as a variance."""
    S, C = 4, 32
    assert flops.combine_ops(S, C, "groupwise") == 2 * C * S + C
    assert flops.combine_ops(S, C, "variance") == 3 * C * S + 4 * C
    args = (1, 5, 48, 216, 288, C)
    n = 48 * 216 * 288
    corr = roofline.cv_work(*args, "groupwise", 1, 2)
    var = roofline.cv_work(*args, "variance", 1, 2)
    assert var[0] - corr[0] == n * (C - 1) * 2
    assert var[1] - corr[1] == n * (C * S + 3 * C)
    cfg = {**load_json("configs", "casmvsnet.json"),
           "cost_volume": "groupwise"}
    assert roofline.cascade_bound_s(cfg, *EVAL) < BOUNDS["casmvsnet"][0]
    assert architecture(cfg).flops(cfg, *EVAL) < FLOPS["casmvsnet"][0]
    with pytest.raises(KeyError):
        flops.combine_ops(S, C, "sum")
