"""``casmvsnet_pl_tpu_torch/utils/profiling.py`` on the CPU against the
JAX package's ``utils/profiling.py``: the same names, the trace file, the
step timer's EMA on the same clock readings, and what the memory helpers
give without a card. On the card, ``chip_smoke.py`` phase 48 reads a trace
for the cost-volume kernel and the card's memory."""
import glob
import json

import pytest
import torch

from casmvsnet_pl_tpu.utils import profiling as jax_profiling
from casmvsnet_pl_tpu_torch import utils
from casmvsnet_pl_tpu_torch.utils import profiling

NAMES = ("trace", "StepTimer", "device_memory_stats", "live_array_bytes",
         "log_compile_time")


def test_names_of_the_jax_module():
    for name in NAMES:
        assert callable(getattr(jax_profiling, name))
        assert getattr(utils, name) is getattr(profiling, name)


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    a = torch.rand(32, 48)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a.T).relu()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::mm", "aten::relu"} <= ops
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def test_step_timer_is_jax_ema(monkeypatch):
    clock = [0.0, 0.5, 0.75, 1.5, 1.625, 3.0]
    got, want = [], []
    for module, out, sync in ((profiling, got, True),
                              (jax_profiling, want, None)):
        ticks = iter(clock)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(smoothing=0.8)
        out.extend(timer.tick(sync) for _ in clock)
    assert got == want
    assert got[:2] == [0.0, 0.5] and got[2] == pytest.approx(0.45)


def test_step_timer_syncs_only_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    timer = profiling.StepTimer()
    timer.tick(torch.zeros(2))           # a CPU tensor: nothing to wait for
    timer.tick()
    assert calls == []


def test_memory_helpers_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == []
    assert profiling.live_array_bytes() == 0


def test_log_compile_time_returns_the_output(capsys):
    calls = []

    def fn(x, y=1):
        calls.append(x)
        return x + y

    assert profiling.log_compile_time(fn, 2, label="add", y=3) == 5
    assert calls == [2, 2]
    out = capsys.readouterr().out
    assert out.startswith("[add] first(build+run)=") and "steady=" in out
