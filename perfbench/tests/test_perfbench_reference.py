"""The plain reference against the port's CPU path, on the same seeded
weights and scenes at 64x64, for both configurations: the eval forward in
float32, and the first training step (loss, the gradient as Adam takes it,
the parameters' change)."""
from __future__ import annotations

import pytest
import torch

from perfbench import compare, program, scenes
from perfbench.harness import load_json
from perfbench.reference.model import CascadeMVSNet
from perfbench.reference.train import BETAS, train_steps

CONFIGS = ("casmvsnet", "casmvsnet_gwc8")
WH = (64, 64)


def _batch(cfg, n_views, rows):
    return scenes.make_batch(5, rows, WH, n_views, 1000.0 * 64 / 1152, cfg,
                             "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_port(name):
    cfg = load_json("configs", f"{name}.json")
    w = program.draw_weights(cfg, 3, "cpu")
    b = _batch(cfg, 5, [0])
    port = program.port_model(cfg, w, "cpu", torch.float32).eval()
    ref = CascadeMVSNet(cfg)
    ref.load_state_dict(w, strict=True)
    ref.eval()
    with torch.no_grad():
        got = port(b["imgs"], b["proj_mats"], cfg["init_depth_min"],
                   cfg["depth_interval"])
        want = ref(b["imgs"], b["proj_mats"], b["init_depth_min"],
                   b["depth_interval"])
    for l in range(3):
        # float32 rounding of depths near 600 mm: a few ulps
        assert (got[f"depth_{l}"] - want[f"depth_{l}"]).abs().max() < 2e-3
        assert (got[f"confidence_{l}"] - want[f"confidence_{l}"]).abs() \
            .max() < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_one_adam_step_matches_the_port(name):
    cfg = load_json("configs", f"{name}.json")
    w = program.draw_weights(cfg, 4, "cpu")
    b = _batch(cfg, 3, [0, 1])
    tr, state = program.trainer(cfg, w, "cpu")
    state, logs = tr.train_step(state, b)
    grads = {n: state.optimizer.state[p]["exp_avg"] / (1 - BETAS[0])
             for n, p in state.model.named_parameters()}
    change = {n: p.detach() - w[n] for n, p in state.model.named_parameters()}
    ref = train_steps(cfg, w, [b])
    nums = compare.train_numbers([float(logs["train/loss"])], grads, change,
                                 ref)
    # float32 on both sides. At 64x64 BatchNorm's backward (a few values a
    # channel at 1/8 scale) amplifies rounding: the port's float32 gradient
    # lies 4e-4 from its own float64 one, the worst leaf's norm 2e-3 to
    # 6e-3 from the reference's; a fault reads 1e-1 and more
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap_median"] < 5e-4
    assert nums["grad_gap_worst"] < 2e-2
    assert nums["change_gap"] < 5e-3
    # the cost's bias under the softmax over depth is left out, nothing else
    dropped = set(grads) - set(compare.kept_leaves(ref["raw_grads"]))
    assert dropped and all(k.endswith("prob.bias") for k in dropped)
