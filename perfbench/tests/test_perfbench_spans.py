"""The span metrics (``spans.py`` and its ten readers in ``metrics/``): each
reads the number expected of a synthetic record, None from a program
without the recorder, and a small traced CPU run of each cell reads every
new metric, while the metrics read from outside the program read the same
as with the program's spans off."""
from __future__ import annotations

import contextlib
import os

import pytest
import torch

from perfbench import harness
from perfbench.run import per_layer

EVAL = "casmvsnet.eval_1152x864x5"
TRAIN = ("casmvsnet.train_640x512x3_b2", "casmvsnet_gwc8.train_640x512x3_b2")
NEW = {
    EVAL: ("features_ms.eval", "cost_volume_ms.eval", "cost_reg_ms.eval",
           "prob_conv_ms.eval", "regression_ms.eval", "host_syncs.eval"),
    TRAIN[0]: ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
               "host_syncs.train"),
}
NEW[TRAIN[1]] = NEW[TRAIN[0]]


def _stats(count, device_s, self_s=None):
    return {"count": count, "device_s": device_s,
            "self_device_s": device_s if self_s is None else self_s,
            "host_s": device_s}


RECORD = {
    "cascade.features": _stats(4, 0.024),
    "cascade.cost_volume": _stats(12, 0.0052),
    "cascade.cost_reg": _stats(12, 0.136, self_s=0.06),
    "cascade.prob": _stats(12, 0.076),
    "cascade.regression": _stats(12, 0.008),
    "host_sync": _stats(8, 0.0004),
    "trainer.step": _stats(4, 0.28, self_s=0.004),
    "trainer.forward": _stats(4, 0.1),
    "trainer.backward": _stats(4, 0.14),
    "trainer.optimizer": _stats(4, 0.006),
}
WANT = {"features_ms.eval": 6.0, "cost_volume_ms.eval": 1.3,
        "cost_reg_ms.eval": 15.0, "prob_conv_ms.eval": 19.0,
        "regression_ms.eval": 2.0, "host_syncs.eval": 2.0,
        "forward_ms.train": 25.0, "backward_ms.train": 35.0,
        "optimizer_ms.train": 1.5, "host_syncs.train": 2.0}


def _read(name, run):
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    return harness.load_module(path, f"t_{name}").read(run)


@pytest.fixture
def record(monkeypatch):
    from casmvsnet_pl_tpu_torch.utils import profiling
    held = {"record": RECORD}
    monkeypatch.setattr(profiling, "span_summary", lambda: held["record"])
    return held


def test_each_reader_on_a_synthetic_record(record):
    run = {"units": 4}
    for name, want in WANT.items():
        assert _read(name, run) == pytest.approx(want), name
    # no sync recorded in a recorded window reads 0, not nothing
    record["record"] = {k: v for k, v in RECORD.items() if k != "host_sync"}
    assert _read("host_syncs.eval", run) == 0.0
    assert _read("host_syncs.train", run) == 0.0
    # a record of another window (no trainer.step) reads nothing
    record["record"] = {"cascade.features": RECORD["cascade.features"]}
    assert _read("host_syncs.train", run) is None
    assert _read("forward_ms.train", run) is None
    assert _read("features_ms.eval", {"units": 0}) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from casmvsnet_pl_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_summary")
    for name in WANT:
        assert _read(name, {"units": 4}) is None


def _metrics(name, spans_on: bool, monkeypatch):
    if not spans_on:            # the program as it was before its spans
        from casmvsnet_pl_tpu_torch.engine import trainer
        from casmvsnet_pl_tpu_torch.models import cascade, cost_reg
        for mod in (cascade, cost_reg, trainer):
            monkeypatch.setattr(mod, "span",
                                lambda *a, **k: contextlib.nullcontext())
    cell, cfg, mix = harness.load_cell(name)
    res = harness.run_cell(name, [2 ** 31 + 11], 0.2, True,
                           torch.device("cpu"), size=(64, 64))[0]
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())
    return per_layer(name, cell, cfg, mix, res, "cpu", (64, 64))


@pytest.mark.parametrize("name", [EVAL, *TRAIN])
def test_a_traced_cpu_run_reads_every_new_metric(name, monkeypatch):
    on = _metrics(name, True, monkeypatch)
    for m in NEW[name]:
        assert on[m]["value"] is not None and on[m]["value"] >= 0, m
    assert on[NEW[name][-1]]["value"] == (2.0 if name == EVAL else 0.0)
    with monkeypatch.context() as mp:
        off = _metrics(name, False, mp)
    assert not set(NEW[name]) & set(off)
    assert {k: v for k, v in on.items() if k not in NEW[name]} == off
