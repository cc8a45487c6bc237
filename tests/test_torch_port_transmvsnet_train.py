"""TransMVSNet's training on the port's normal path, on the CPU: the focal
loss against a hand computation, ``plain_deform_conv``'s gradients under
float64 ``gradcheck``, the model's training outputs and objective, and
three ``MVSTrainer`` steps of the port (plain routes, float32) against the
benchmark's plain reference step (``perfbench/reference/train_focal.py``)
from the same seeded weights over the same batches.

The reference's windows of levels 1 and 0 are centred on the port's
winner-take-all depths of the same step (recorded as the benchmark's cell
records them, ``perfbench/traffic/focal_steps.py``): on near-uniform
probabilities a winner-take-all pick can flip between two float32
summation orders and move a window, which is not what these tests hold.
"""
import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from casmvsnet_pl_tpu_torch import losses  # noqa: E402
from casmvsnet_pl_tpu_torch.ops.deform_conv import (  # noqa: E402
    plain_deform_conv)
from perfbench import compare, program, scenes  # noqa: E402
from perfbench.harness import architecture, load_cell  # noqa: E402
from perfbench.reference import train_focal  # noqa: E402
from perfbench.reference.model import float32_exact  # noqa: E402
from perfbench.reference.train import BETAS  # noqa: E402
from perfbench.traffic.focal_steps import (record_centres,  # noqa: E402
                                           step_centres)

CELL, CFG, MIX = load_cell("transmvsnet_train.train_640x512x5_b2")
WH = (64, 64)                  # the 1/4 level 16 x 16, its U-Net 2 x 2
VIEWS = 3
STEPS = 3


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


def _hand_focal(prob, hyp, gt, mask, gamma, eps):
    """The mean over masked pixels of -(1 - P)^gamma log(P + eps), P the
    probability of the hypothesis nearest the ground truth, pixel by
    pixel in Python."""
    B, D, H, W = prob.shape
    total, count = 0.0, 0
    for b in range(B):
        for i in range(H):
            for j in range(W):
                if not mask[b, i, j]:
                    continue
                dist = [abs(float(hyp[b, d, i, j]) - float(gt[b, i, j]))
                        for d in range(D)]
                p = float(prob[b, dist.index(min(dist)), i, j])
                total += -(1 - p) ** gamma * math.log(p + eps)
                count += 1
    return total / count


def test_the_focal_loss_is_the_hand_computation():
    g = torch.Generator().manual_seed(4)
    results, depths, masks, want = {}, {}, {}, 0.0
    for l, (D, H, W) in enumerate(((4, 3, 5), (6, 2, 3), (8, 2, 2))):
        prob = torch.softmax(torch.randn((2, D, H, W), generator=g) * 2, 1)
        start = 500 + 10 * torch.rand((2, 1, H, W), generator=g)
        hyp = start + 2.0 * torch.arange(D).reshape(1, D, 1, 1)
        # ground truths inside, below and above the window
        gt = start[:, 0] + torch.empty((2, H, W)).uniform_(-6, 2 * D + 6,
                                                           generator=g)
        mask = torch.rand((2, H, W), generator=g) > 0.3
        results[f"prob_{l}"], results[f"depth_values_{l}"] = prob, hyp
        depths[f"level_{l}"], masks[f"level_{l}"] = gt, mask
        want += losses.FOCAL_WEIGHTS[l] * _hand_focal(
            prob, hyp, gt, mask, losses.FOCAL_GAMMA, losses.LOG_EPS)
    got = losses.focal_loss(results, depths, masks)
    assert got.dtype == torch.float32
    assert math.isclose(float(got), want, rel_tol=1e-5)
    # the configuration's choices are the loss's
    assert CFG["gamma"] == losses.FOCAL_GAMMA
    assert tuple(CFG["loss_weights"]) == losses.FOCAL_WEIGHTS
    assert CFG["log_eps"] == losses.LOG_EPS
    ref = train_focal.focal_loss(results, depths, masks, CFG)
    assert math.isclose(float(ref), want, rel_tol=1e-5)


@pytest.mark.parametrize("C", [8, 16])
def test_the_plain_deformable_conv_passes_gradcheck_in_float64(C):
    """Offsets of -2 to 2 px whose fractions keep every sample off the
    integer grid (where floor's derivative jumps), taps inside and outside
    the image."""
    g = torch.Generator().manual_seed(C)
    N, H, W = 1, 5, 4
    x = torch.randn((N, C, H, W), generator=g, dtype=torch.float64)
    om = torch.randn((N, 27, H, W), generator=g, dtype=torch.float64)
    whole = torch.randint(-2, 2, (N, 18, H, W), generator=g).double()
    om[:, :18] = whole + 0.1 + 0.8 * torch.rand(
        (N, 18, H, W), generator=g, dtype=torch.float64)
    w = torch.randn((C, C, 3, 3), generator=g, dtype=torch.float64) / C
    args = tuple(t.requires_grad_() for t in (x, om, w))
    assert plain_deform_conv(*args).dtype == torch.float64
    assert torch.autograd.gradcheck(plain_deform_conv, args, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_the_forward_returns_volumes_only_when_asked(threads):
    arch = architecture(CFG)
    weights = program.draw_weights(CFG, 9, "cpu")
    port = arch.port_model(CFG, weights, "cpu", torch.float32).eval()
    batch = scenes.make_batch(9, [0], WH, VIEWS, 60.0, CFG, "cpu")
    args = (batch["imgs"], batch["proj_mats"], batch["init_depth_min"],
            batch["depth_interval"])
    with torch.no_grad():
        plain = port(*args)
        full = port(*args, volumes=True)
    assert sorted(plain) == sorted(f"{k}_{l}" for k in ("depth",
                                                        "confidence")
                                   for l in range(3))
    for l, D in enumerate(CFG["n_depths"]):
        prob, hyp = full[f"prob_{l}"], full[f"depth_values_{l}"]
        assert prob.shape == hyp.shape == (1, D, 64 >> l, 64 >> l)
        assert torch.allclose(prob.sum(1), torch.ones(()), atol=1e-5)
        # winner-take-all: the depth is the hypothesis of the largest
        # probability
        idx = prob.argmax(1, keepdim=True)
        assert torch.equal(hyp.gather(1, idx)[:, 0], full[f"depth_{l}"])
        assert torch.equal(plain[f"depth_{l}"], full[f"depth_{l}"])


def _port_steps(seed, batches):
    """The port's trainer (float32 on the CPU, the configuration's Adam)
    over ``batches``: the losses, the first gradient as Adam took it, the
    change, and each step's centres."""
    weights = program.draw_weights(CFG, seed, "cpu")
    tr, state = program.trainer(CFG, weights, "cpu")
    named = list(state.model.named_parameters())
    seen, unhook = record_centres(state.model)
    losses_, grads = [], None
    for j, batch in enumerate(batches):
        state, logs = tr.train_step(state, batch)
        losses_.append(float(logs["train/loss"]))
        if j == 0:
            grads = {n: state.optimizer.state[p]["exp_avg"] / (1 - BETAS[0])
                     for n, p in named}
    unhook()
    change = {n: p.detach() - weights[n] for n, p in named}
    return weights, losses_, grads, change, step_centres(seen, 3)


@pytest.mark.parametrize("seed", [3_000_000_017, 12])
def test_three_training_steps_match_the_reference(seed, threads):
    """Tolerances, float32 against float32 (each summation order its own;
    the readings over both seeds in brackets): the first step's loss
    within 1e-5 (1e-7), every step's within 5e-3 (1.1e-3, the third step,
    after two updates); the first gradient, compared as the cell compares
    it (``compare.train_numbers``), within 2e-3 at the median leaf (2.6e-4)
    and 5e-2 at the worst (1.3e-2: BatchNorm biases of the trunk, sums over
    every pixel that cancel); the change after three Adam steps within 0.3
    at the worst leaf (0.08): Adam divides each element by the root of its
    own squared gradient, so elements whose gradient is near zero take
    steps of the learning rate whose sign rounding picks, and the gap grows
    from step to step."""
    batches = [scenes.make_batch(seed, range(2 * j, 2 * j + 2), WH, VIEWS,
                                 60.0, CFG, "cpu") for j in range(STEPS)]
    weights, got_losses, grads, change, centres = _port_steps(seed, batches)
    with float32_exact():
        ref = train_focal.train_steps(CFG, weights, batches, centres=centres)
    assert len(got_losses) == len(ref["losses"]) == STEPS
    numbers = compare.train_numbers(got_losses, grads, change, ref)
    assert math.isclose(got_losses[0], ref["losses"][0], rel_tol=1e-5)
    assert numbers["loss_gap"] <= 5e-3, numbers
    assert numbers["grad_gap_median"] <= 2e-3, numbers
    assert numbers["grad_gap_worst"] <= 5e-2, numbers
    assert numbers["change_gap"] <= 0.3, numbers
    # every leaf of the port has a gradient, the reference's names
    assert set(grads) == set(ref["grads"])
    assert all(torch.isfinite(g).all() for g in grads.values())
