"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration
(``configs/``), its traffic mix (``traffic/<mix>.json``, whose ``kind`` is
the loop ``traffic/<kind>.py``) and its cards. The run checks for the
cards (none: exit 2, no result), prints the card check on standard error,
sets up from the seed (the port's kernel library from
``casmvsnet_pl_tpu_torch/_build/``, weights and scenes on the card, the
cell's shapes warmed up), measures for ``--seconds`` (``--trace 1``: a
traced window of the mix's ``trace_units`` instead), decides ``correct``
against the plain reference, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each number compared beside its limit. A run that finds JAX or
the JAX package loaded once the window has closed exits 3 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "casmvsnet_pl_tpu")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def per_layer(name: str, cell: dict, config: dict, mix: dict, res: dict,
              card: str, img_wh) -> dict:
    """The cell's per-layer metrics (``BENCHMARK.json``'s ``per_layer``
    entries whose ``workloads`` list the cell), each read by its file."""
    from perfbench.harness import HERE, benchmark, load_module
    run = {"trace": res["trace"], "config": config, "mix": mix,
           "chips": res["chips"], "units": res["units"], "card": card,
           "img_wh": img_wh}
    out = {}
    for m in benchmark()["per_layer"]:
        if name not in m["workloads"]:
            continue
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        value = load_module(path, f"perfbench_metric_{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(name: str, res: dict) -> dict:
    from perfbench.harness import benchmark
    out = {}
    for m in benchmark()["end_to_end"]:
        if name in m.get("workloads", [name]) and m["name"] in res["metrics"]:
            out[m["name"]] = {"value": res["metrics"][m["name"]],
                              "unit": m["unit"]}
    return out


def finite(x):
    """``x`` with every number that is not finite as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch
    from perfbench import card as card_check, compare
    from perfbench.harness import load_cell, run_cell

    cell, config, mix = load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"perfbench: torch imported {time.perf_counter() - T_START:.3f} s "
          "after the process's start", file=sys.stderr, flush=True)
    card = card_check.report(device)
    from perfbench import program
    print(f"perfbench: kernel library ready in {program.build_kernels()!r} s"
          f" ({time.perf_counter() - T_START:.3f} s after the start)",
          file=sys.stderr, flush=True)
    res = run_cell(args.workload, [args.seed], args.seconds,
                   bool(args.trace), device, T_START)[0]

    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    device_info = {"platform": "gpu", "kind": card, "count": chips,
                   "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": compare.passed(res["checks"]),
            "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        t = res["trace"]
        device_info["busy_s"] = t.get("busy_s_mean", t["busy_s"])
        device_info["window_s"] = t.get("window_s_mean", t["window_s"])
        line["metrics"] = per_layer(args.workload, cell, config, mix, res,
                                    card, tuple(mix["img_wh"]))
        line["breakdown"] = t["breakdown"]
    else:
        line["metrics"] = end_to_end(args.workload, res)
    line["device"] = device_info
    line["checks"] = res["checks"]
    compare.print_checks(res["checks"])
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
