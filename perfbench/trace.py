"""The traced window: ``torch.profiler`` over a fixed amount of work, read
back from its Chrome trace.

The window is the host span of a ``perfbench.window`` annotation that ends
after a device synchronize. Device operations are the trace's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events (the ``gpu_user_annotation``
events span kernels and are not work). Busy time is the length of the union
of their intervals inside the window, so that kernels overlapping on two
streams (DDP's NCCL stream beside compute) count once. An idle gap is a
stretch of the window that no device operation covers; it is named by the
innermost host event (``cpu_op``, ``cuda_runtime``, ``cuda_driver``) open
at its middle, on any thread.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
from typing import Callable

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
TOP = 10


def profile(work: Callable[[], int]) -> tuple[int, list[dict]]:
    """Run ``work`` (which returns its count of units and synchronizes the
    device) under the profiler; returns (units, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            units = work()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return units, events


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_gaps(gaps: list[tuple[float, float]],
              host: list[tuple[float, float, str]]) -> list[str]:
    """For each gap, the name of the innermost host event (latest start)
    open at its middle, or "(no host event)"."""
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    host = sorted(host)
    names = ["(no host event)"] * len(gaps)
    active: list[tuple[float, float, str]] = []   # max-heap on start
    j = 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(host) and host[j][0] <= mid:
            s, e, n = host[j]
            heapq.heappush(active, (-s, e, n))
            j += 1
        # an event closed before this middle is closed for every later one
        while active and active[0][1] < mid:
            heapq.heappop(active)
        if active:
            names[i] = active[0][2]
    return names


def summarize(events: list[dict]) -> dict:
    """The window's length and busy time (s), each device kernel's count
    and seconds by name, and the breakdown: the device operations with the
    most time and the idle time by the host event open during each gap."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels, by_name = [], {}, {}
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        dev.append((s, t))
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if cat == "kernel":
            n, sec = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, sec + (t - s) * 1e-6)
    busy = union(dev)
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < w1:
        gaps.append((at, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    idle: dict[str, float] = {}
    for (s, e), n in zip(gaps, name_gaps(gaps, host)):
        idle[n] = idle.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:160], sec * 1e-6] for n, sec in ops],
            "idle_gaps": sorted(([n[:160], sec] for n, sec in idle.items()),
                                key=lambda kv: -kv[1])[:TOP]},
    }
