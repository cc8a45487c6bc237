"""The span recorder of ``casmvsnet_pl_tpu_torch/utils/profiling.py`` on the
CPU: off without a profiler (nothing recorded, outputs equal to the bit to
a traced run's), the cascade's and the trainer's spans and their parents
under one, the Chrome trace's annotations, a record per profiler session,
self time and the cap. On the card the spans carry CUDA events;
``perfbench/metrics`` reads them in the benchmark's traced runs."""
import glob
import json

import pytest
import torch

from casmvsnet_pl_tpu_torch import utils
from casmvsnet_pl_tpu_torch.entry import entry, train_entry
from casmvsnet_pl_tpu_torch.utils import profiling
from casmvsnet_pl_tpu_torch.utils.profiling import (RECORDER, SpanRecorder,
                                                    span, span_summary)

LEVEL_SPANS = ("cascade.level", "cascade.hypotheses", "cascade.cost_volume",
               "cascade.cost_reg", "cascade.prob", "cascade.regression")
PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer",
          "trainer.logs")
SYNC_SITES = ["from_features.depth_interval", "from_features.init_depth_min"]
WH = (64, 32)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def _forward():
    fn, args = entry("cpu", img_wh=WH)
    return lambda: fn(*args)


def _step():
    """A fresh trainer's first step on the same batch each call: (logs,
    parameters after the step, their gradients)."""
    trainer, state, batch = train_entry("cpu", img_wh=WH, n_depths=(8, 8, 8))
    state, logs = trainer.train_step(state, batch)
    params = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return logs, params, grads


def test_names_in_utils():
    for name in ("span", "span_summary"):
        assert getattr(utils, name) is getattr(profiling, name)


@pytest.fixture
def one_thread():
    """CPU convolution backward sums in a thread-dependent order: one
    thread makes two steps comparable to the bit."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_off_records_nothing_and_outputs_equal_a_traced_run(one_thread):
    forward = _forward()
    spans, session = RECORDER.spans, RECORDER.session
    assert span("cascade.features") is span("host_sync", site="x")
    off = forward()
    off_logs, off_params, off_grads = _step()
    assert RECORDER.spans is spans and RECORDER.session == session
    on = _profiled(forward)
    on_logs, on_params, on_grads = _profiled(_step)
    assert RECORDER.spans is not spans and RECORDER.spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert sorted(off_logs) == sorted(on_logs)
    for k in off_logs:
        assert torch.equal(torch.as_tensor(off_logs[k]),
                           torch.as_tensor(on_logs[k])), k
    for n in off_params:
        assert torch.equal(off_params[n], on_params[n]), n
        assert torch.equal(off_grads[n], on_grads[n]), n


def test_a_forward_records_each_level_and_the_host_syncs():
    _profiled(_forward())
    got = {s.name: s for s in RECORDER.spans}
    count = span_summary()
    assert count["cascade.features"]["count"] == 1
    for name in LEVEL_SPANS:
        assert count[name]["count"] == 3, name
    levels = [s for s in RECORDER.spans if s.name == "cascade.level"]
    assert [s.attrs["level"] for s in levels] == [2, 1, 0]
    for s in RECORDER.spans:
        if s.name in LEVEL_SPANS[1:]:
            want = "cascade.cost_reg" if s.name == "cascade.prob" \
                else "cascade.level"
            assert s.parent.name == want, s.name
    assert got["cascade.level"].parent is None
    syncs = [s for s in RECORDER.spans if s.name == "host_sync"]
    assert sorted(s.attrs["site"] for s in syncs) == SYNC_SITES
    assert all(s.parent is None for s in syncs)
    assert RECORDER.dropped == 0


def test_a_step_records_its_four_phases_once():
    _profiled(_step)
    count = span_summary()
    assert count["trainer.step"]["count"] == 1
    for name in PHASES:
        assert count[name]["count"] == 1, name
    step = next(s for s in RECORDER.spans if s.name == "trainer.step")
    assert step.parent is None
    for s in RECORDER.spans:
        if s.name in PHASES:
            assert s.parent is step
    features = next(s for s in RECORDER.spans if s.name == "cascade.features")
    assert features.parent.name == "trainer.forward"
    # the batch's depth bounds are tensors on the device: no copy, no wait
    assert "host_sync" not in count
    total = count["trainer.step"]
    phases = sum(count[n]["device_s"] for n in PHASES)
    assert total["self_device_s"] == pytest.approx(total["device_s"] - phases)


def test_the_chrome_trace_nests_the_spans_in_the_forward(tmp_path):
    forward = _forward()
    with profiling.trace(str(tmp_path)):
        with torch.autograd.profiler.record_function("test.forward"):
            forward()
    path, = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == name]

    (f0, f1), = spans("test.forward")
    names = ("cascade.features", "host_sync") + LEVEL_SPANS
    for name in names:
        got = spans(name)
        assert len(got) == (1 if name == "cascade.features" else
                            2 if name == "host_sync" else 3), name
        assert all(f0 <= s and e <= f1 for s, e in got), name
    for s, e in spans("cascade.prob"):
        assert any(r0 <= s and e <= r1 for r0, r1 in
                   spans("cascade.cost_reg"))


def test_a_new_profiler_session_starts_a_new_record():
    rec = SpanRecorder()

    def session(name):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with rec.span(name):
                pass

    session("first")
    assert set(rec.summary()) == {"first"}
    first = rec.session
    session("second")
    assert set(rec.summary()) == {"second"} and rec.session != first
    with rec.span("off"):
        pass
    assert set(rec.summary()) == {"second"}
    # a session in which no span opens leaves no record of an older one
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pass
    assert rec.summary() == {}


def _synthetic(rec, name, t0, t1, parent=None):
    s = profiling._Span(name, {}, [parent] if parent else [])
    s.t0, s.t1 = t0, t1
    rec.spans.append(s)
    return s


def test_self_time_is_the_span_less_its_children():
    rec = SpanRecorder()
    rec.session = profiling._sessions[0]
    outer = _synthetic(rec, "outer", 0.0, 10.0)
    a = _synthetic(rec, "child", 1.0, 3.0, outer)
    _synthetic(rec, "child", 4.0, 8.0, outer)
    _synthetic(rec, "leaf", 1.5, 2.5, a)
    _synthetic(rec, "outer", 20.0, 21.0)
    open_span = _synthetic(rec, "open", 21.0, None)
    assert open_span.t1 is None
    got = rec.summary()
    assert got["outer"] == {"count": 2, "device_s": 11.0,
                            "self_device_s": 5.0, "host_s": 11.0}
    assert got["child"]["count"] == 2
    assert got["child"]["device_s"] == pytest.approx(6.0)
    assert got["child"]["self_device_s"] == pytest.approx(5.0)
    assert got["leaf"]["self_device_s"] == pytest.approx(1.0)
    assert "open" not in got


def test_the_cap_counts_dropped_spans():
    rec = SpanRecorder(cap=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with rec.span(f"s{i}"):
                torch.ones(4).sum()
    assert [s.name for s in rec.spans] == ["s0", "s1", "s2"]
    assert rec.dropped == 2
    assert rec.summary()["s2"]["count"] == 1
    # a dropped span still annotates the trace
    assert {"s3", "s4"} <= {e.key for e in prof.key_averages()}


def test_sessions_reuse_the_timing_events(monkeypatch):
    """With CUDA initialized each span records a pair of the recorder's
    events (here fakes on a clock that ticks 1 ms a record): made once, the
    n-th span of every session takes the n-th pair, read once in
    ``summary`` after one sync."""
    ticks, syncs = iter(range(1000)), []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream):
            assert stream == "stream"
            self.t = next(ticks)

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    rec = SpanRecorder()
    firsts = []
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with rec.span("outer"):
                with rec.span("inner"):
                    pass
        firsts.append([s.events for s in rec.spans])
        got = rec.summary()
        # outer: records 0 .. 3, inner: 1 .. 2 (ms on the fake clock)
        assert got["outer"]["device_s"] == pytest.approx(3e-3)
        assert got["outer"]["self_device_s"] == pytest.approx(2e-3)
        assert got["inner"]["device_s"] == pytest.approx(1e-3)
    assert firsts[0] == firsts[1] and len(rec._events) == 4
    assert syncs == [1, 1]
