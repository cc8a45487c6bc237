"""The traced window's arithmetic on synthetic traces: busy time is the
union of device intervals, so NCCL kernels overlapping compute on another
stream count once; idle gaps are named by the innermost host event open
at their middle; the metrics read kernels by name."""
from __future__ import annotations

import pytest

from perfbench import readers, trace


def _x(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def two_streams():
    return [
        _x("user_annotation", trace.WINDOW, 0.0, 1000.0, 1),
        _x("gpu_user_annotation", trace.WINDOW, 0.0, 1000.0),
        # compute on stream 7: [100, 400] and [500, 700]
        _x("kernel", "sm90_xmma_dgrad", 100.0, 300.0, 7),
        _x("kernel", "void cost_volume_bwd_kernel<bf16, 32, 1, 2>", 500.0,
           200.0, 7),
        # NCCL on stream 20, overlapping both: [350, 550]
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 350.0, 200.0,
           20),
        _x("gpu_memcpy", "Memcpy DtoH", 900.0, 50.0, 7),
        # host: an optimizer step over [0, 1000], a sync in [720, 890]
        _x("cpu_op", "Optimizer.step#Adam.step", 0.0, 1000.0, 1),
        _x("cuda_runtime", "cudaStreamSynchronize", 720.0, 170.0, 1),
        _x("cpu_op", "aten::copy_", 950.0, 40.0, 1),
    ]


def test_busy_is_the_union_of_overlapping_streams():
    s = trace.summarize(two_streams())
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: [100, 700] and [900, 950]; a plain sum would say 750 us
    assert s["busy_s"] == pytest.approx(650e-6)
    run = {"trace": s, "units": 1}
    assert readers.idle_pct(run) == pytest.approx(35.0)
    assert s["kernels"]["sm90_xmma_dgrad"] == (1, pytest.approx(300e-6))
    assert "Memcpy DtoH" not in s["kernels"]      # a copy is not a kernel


def test_gaps_are_named_by_the_innermost_host_event():
    s = trace.summarize(two_streams())
    idle = dict(s["breakdown"]["idle_gaps"])
    # [0, 100] and [700, 900] under Adam's step, the sync innermost in the
    # second; [950, 1000] after aten::copy_ closed at 990: its middle 975
    # is inside the copy
    assert idle["Optimizer.step#Adam.step"] == pytest.approx(100e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert idle["aten::copy_"] == pytest.approx(50e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["sm90_xmma_dgrad"] == pytest.approx(300e-6)
    assert len(s["breakdown"]["device_ops"]) <= trace.TOP


def test_kernels_by_name():
    run = {"trace": trace.summarize(two_streams()), "units": 2}
    n, sec = readers.kernel_seconds(run, lambda k: k.lower()
                                    .startswith("nccl"))
    assert (n, sec) == (1, pytest.approx(200e-6))
    n, _ = readers.kernel_seconds(run, lambda k: "cost_volume_bwd_kernel"
                                  in k)
    assert n == 1
    assert readers.per_unit(run, 3.0) == 1.5


def test_a_window_is_required():
    with pytest.raises(ValueError):
        trace.summarize(two_streams()[1:])
