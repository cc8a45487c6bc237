"""The control comes out not correct: the plain reference, computed in fp8
(one scale a tensor), put in the program's place, against the cells' own
limits, on three seeds at a size a test run holds. Needs the card (the
cells' limits are the card's bf16 readings); on the card, at the cells'
own sizes, ``readings.py --mode control`` reads the same."""
from __future__ import annotations

import pytest

from perfbench import compare
from perfbench.harness import Ctx, load_cell, run_cell

SEEDS = (11, 2200000000, 33)


@pytest.mark.cuda
def test_eval_control_fails(card):
    for r in run_cell("casmvsnet.eval_1152x864x5", SEEDS, 0.5, False, card,
                      mode="control", size=(576, 448)):
        assert not compare.passed(r["checks"]), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["casmvsnet.train_640x512x3_b2",
                                  "casmvsnet_gwc8.train_640x512x3_b2"])
def test_train_control_fails(card, name):
    from perfbench.traffic.train_steps import control_numbers
    cell, config, mix = load_cell(name)
    ctx = Ctx(name, cell, config, mix, list(SEEDS), 0.0, False, card, 0.0,
              "control", size=(320, 256))
    for seed in SEEDS:
        table = compare.checks(control_numbers(ctx, seed, cell["chips"]),
                               cell["limits"], cuda=False)
        assert not compare.passed(table), table
