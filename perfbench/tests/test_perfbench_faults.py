"""``correct`` comes out false with the timed path broken underneath, once
for each fault a cell can have, and true without one: the harness driven
on the CPU at 64x64 with the cells' own limits (the card check skipped;
the CPU path runs the port's plain cost volume in float32)."""
from __future__ import annotations

import pytest
import torch

from perfbench import compare
from perfbench.harness import run_cell

CPU = torch.device("cpu")
SEED = 3_000_000_017          # over 2^31: seeds need more than 32 bits


@pytest.fixture
def restore(monkeypatch):
    """The faults patch the port in this process (rank 0's); undo them."""
    import torch.distributed as dist

    import eval_torch
    from casmvsnet_pl_tpu_torch.engine.trainer import MVSTrainer
    monkeypatch.setattr(MVSTrainer, "train_step", MVSTrainer.train_step)
    monkeypatch.setattr(eval_torch.Predictor, "__call__",
                        eval_torch.Predictor.__call__)
    monkeypatch.setattr(dist, "all_reduce", dist.all_reduce)


def _correct(cell, fault=None, mode="program"):
    r = run_cell(cell, [SEED], 0.3, False, CPU, mode=mode, fault=fault,
                 size=(64, 64))[0]
    return compare.passed(r["checks"]), r


@pytest.mark.parametrize("cell,fault", [
    ("casmvsnet.eval_1152x864x5", None),
    ("casmvsnet.eval_1152x864x5", "altered"),
    ("casmvsnet.eval_1152x864x5", "strip"),
    ("casmvsnet.train_640x512x3_b2", None),
    ("casmvsnet.train_640x512x3_b2", "unchanged"),
    ("casmvsnet.train_640x512x3_b2", "half_batch"),
    ("casmvsnet_gwc8.train_640x512x3_b2", None),
    ("casmvsnet_gwc8.train_640x512x3_b2", "unchanged"),
    ("casmvsnet_gwc8.train_640x512x3_b2", "half_batch"),
])
def test_one_card_cells(cell, fault, restore):
    ok, r = _correct(cell, fault)
    assert ok == (fault is None), r["checks"]
    assert r["attempted"] > 0


# the four-card step: the one-card mix on four ranks, with the limits of
# its readings on four H100s (PERF.md, the data-parallel cell under Open
# questions)
DP_LIMITS = {"loss_gap": 0.018, "grad_gap_median": 0.007, "change_gap": 0.5}


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch",
                                   "unchanged"])
def test_data_parallel_step(fault, restore):
    """Four gloo ranks on the CPU (the faults are planted in each rank's
    own process)."""
    from perfbench.harness import Ctx, load_json
    from perfbench.traffic import train_steps_dp
    mix = {**load_json("traffic", "train_640x512x3_b2.json"),
           "kind": "train_steps_dp", "check_every": 4}
    ctx = Ctx("dp4", {"chips": 4, "limits": DP_LIMITS},
              load_json("configs", "casmvsnet.json"), mix, [SEED], 0.3,
              False, CPU, 0.0, fault=fault, size=(64, 64))
    r = train_steps_dp.run(ctx)[0]
    assert compare.passed(r["checks"]) == (fault is None), r["checks"]
    assert r["chips"] == 4
