"""The benchmark's door to the port's span recorder, beside ``program.py``,
its door to the model and the trainer.

The port keeps its spans (``casmvsnet_pl_tpu_torch/utils/profiling.py``:
``span``, ``span_summary``) while a ``torch.profiler`` session records, and
starts a new record with each session, so after a ``--trace 1`` run the
record holds the traced window alone. The readers here give a span's
device ms, or its count, per map or step of the window. A program without
the recorder, or a record without the span, reads None, and the metric is
left out of the line.
"""
from __future__ import annotations

from perfbench.readers import per_unit


def summary() -> dict | None:
    """The port's ``span_summary()`` ({name: {count, device_s,
    self_device_s, host_s}}), or None where the port has no recorder."""
    from casmvsnet_pl_tpu_torch.utils import profiling
    read = getattr(profiling, "span_summary", None)
    return read() if read is not None else None


def span_ms(run: dict, name: str, self_time: bool = False) -> float | None:
    """Device ms of the spans ``name`` per unit (``self_time``: less the
    spans inside them)."""
    stats = (summary() or {}).get(name)
    if not stats:
        return None
    return per_unit(run, 1e3 * stats["self_device_s" if self_time
                                     else "device_s"])


def span_count(run: dict, name: str, within: str) -> float | None:
    """Spans ``name`` per unit: 0 where the record holds the spans
    ``within`` (so the window was recorded) and no ``name``."""
    s = summary() or {}
    if within not in s:
        return None
    return per_unit(run, float(s.get(name, {}).get("count", 0)))
