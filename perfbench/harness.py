"""What the traffic loops share: the run's context, its result, and the
cell's files found by name."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = 2 ** 30


@dataclasses.dataclass
class Ctx:
    """One run of one cell: ``seeds`` (one for ``run.py``; a list for the
    readings that set the limits), ``seconds`` of window, ``trace`` (a
    traced window of the mix's ``trace_units`` instead), the device, the
    perf_counter at the process's start; ``mode`` "program" (the system
    under test), or "control" (the eval loop's maps replaced by the
    reference's in fp8; a training cell's control is
    ``train_steps.control_numbers``, with no program);
    ``fault`` a name of ``faults.py`` to plant in the program; ``size``
    replaces the mix's image size (the CPU tests' small runs)."""
    name: str
    cell: dict
    config: dict
    mix: dict
    seeds: list[int]
    seconds: float
    trace: bool
    device: object
    t_start: float
    mode: str = "program"
    fault: str | None = None
    size: tuple[int, int] | None = None

    @property
    def img_wh(self) -> tuple[int, int]:
        return tuple(self.size or self.mix["img_wh"])


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, config, mix) of the cell ``name``."""
    cell = load_json("workloads", f"{name}.json")
    return cell, load_json("configs", f"{cell['config']}.json"), \
        load_json("traffic", f"{cell['traffic']}.json")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str):
    return importlib.import_module(f"perfbench.traffic.{kind}")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


class Phases:
    """Seconds of each set-up phase, printed on stderr as one line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: list[tuple[str, float]] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self, setup_s: float) -> None:
        import sys
        print("perfbench set-up: " + ", ".join(
            f"{n} {s:.3f} s" for n, s in self.parts) +
            f"; process start to window {setup_s:.3f} s", file=sys.stderr,
            flush=True)


def result(**kw) -> dict:
    """A run's result: ``metrics`` (end-to-end values by name), ``attempted``,
    ``failed``, ``checks`` ({name: {value, limit}}), ``peak_bytes``,
    ``chips``, ``trace`` (the summary of ``trace.py``, traced runs),
    ``units`` (maps or steps in the traced window), and ``numbers``."""
    base = {"metrics": {}, "attempted": 0, "failed": 0, "checks": {},
            "peak_bytes": 0, "chips": 1, "trace": None, "units": 0}
    base.update(kw)
    return base


def run_cell(name: str, seeds: list[int], seconds: float, trace: bool,
             device, t_start: float | None = None, mode: str = "program",
             fault: str | None = None, size=None) -> list[dict]:
    """Set up, measure and check the cell ``name`` for each seed (the
    readings and the tests call this; ``run.py`` after its card check)."""
    cell, config, mix = load_cell(name)
    ctx = Ctx(name, cell, config, mix, list(seeds), seconds, trace, device,
              time.perf_counter() if t_start is None else t_start, mode,
              fault, size)
    return traffic_kind(mix["kind"]).run(ctx)
