"""Profiling and device-memory observability on ``torch.profiler`` and
``torch.cuda``.

Counterpart of ``casmvsnet_pl_tpu/utils/profiling.py``, with its names:

  - :func:`trace`: context manager around ``torch.profiler.profile``
    writing a Chrome trace of everything inside the block (TensorBoard's
    profiler plugin, Perfetto or ``chrome://tracing`` read it);
  - :class:`StepTimer`: wall-clock step timing with a card sync, EMA
    smoothing;
  - :func:`device_memory_stats`: allocated, peak and total bytes per card;
  - :func:`live_array_bytes`: bytes of the live tensors on the cards;
  - :func:`log_compile_time`: the first call (kernel builds, cuDNN's
    algorithm choice, the allocator's growth) against a steady one.
"""
from __future__ import annotations

import contextlib
import time

import torch


def _sync(what=True) -> None:
    """Wait for the card: every queued kernel (``True``) or those of a
    tensor's card (a CUDA tensor); nothing for a CPU tensor, None or
    without a card."""
    if isinstance(what, torch.Tensor):
        if what.is_cuda:
            torch.cuda.synchronize(what.device)
    elif what is True and torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Write a Chrome trace of everything inside the block to ``log_dir``
    (``<host>_<pid>.<time>.pt.trace.json``): the host's operators and,
    with a card, its kernels. Yields the ``torch.profiler.profile``
    object, whose ``key_averages()`` sums the block's time by name.

    View with: tensorboard --logdir <log_dir> (the PyTorch Profiler tab),
    or open the file in Perfetto.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
        _sync()


class StepTimer:
    """Wall-clock step timer with exponential smoothing.

    Example::
        timer = StepTimer()
        for batch in loader:
            state, logs = trainer.train_step(state, batch)
            print(timer.tick(True))   # syncs, returns smoothed s/step
    """

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.ema: float | None = None
        self._last: float | None = None

    def tick(self, sync=None) -> float:
        """Mark the end of a step and return the smoothed seconds a step (0
        before the second tick). ``sync``: a tensor (wait for its card) or
        True (wait for every card) before reading the clock."""
        if sync is not None:
            _sync(sync)
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.smoothing * self.ema + (1 - self.smoothing) * dt)
        self._last = now
        return self.ema if self.ema is not None else 0.0


def device_memory_stats() -> list[dict]:
    """Per visible card: bytes allocated to tensors now and at the peak
    (since the start or ``torch.cuda.reset_peak_memory_stats``), and the
    card's memory. An empty list without a card."""
    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]


def live_array_bytes() -> int:
    """Bytes allocated to live tensors on every visible card (0 without a
    card; CPU tensors are not counted)."""
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def log_compile_time(fn, *args, label: str = "fn", **kwargs):
    """Run ``fn`` twice, each call ended by a card sync, and print the
    first call's seconds (kernel builds, cuDNN's algorithm choice and the
    allocator's growth included) beside the second's; returns the second
    call's output."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    t_steady = time.perf_counter() - t0
    print(f"[{label}] first(build+run)={t_first:.2f}s "
          f"steady={t_steady * 1e3:.1f}ms")
    return out
