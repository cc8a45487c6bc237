"""What the per-layer metrics (``metrics/<name>.py``) share. Each metric's
``read(run)`` takes the traced run: ``trace`` (``trace.summarize``'s dict,
rank 0's), ``config``, ``mix``, ``chips``, ``units`` (maps or steps in the
traced window), ``card`` (the card's name), ``img_wh``; and returns a
number, or None where it finds nothing to read."""
from __future__ import annotations


def idle_pct(run: dict) -> float | None:
    t = run["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_seconds(run: dict, match) -> tuple[int, float]:
    """(launches, seconds) of the traced kernels whose name ``match``es."""
    n = s = 0
    for name, (count, sec) in run["trace"]["kernels"].items():
        if match(name):
            n, s = n + count, s + sec
    return n, s


def per_unit(run: dict, value: float) -> float | None:
    return value / run["units"] if run["units"] else None
