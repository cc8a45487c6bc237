"""Every configuration, cell, traffic mix and metric is found by name, and
``BENCHMARK.json`` agrees with the files; a new cell, mix and metric, and a
new architecture, are picked up by adding files alone."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

from perfbench import harness

BENCH = harness.benchmark()


def check_config(entry: dict) -> None:
    """A configuration's file agrees with its ``BENCHMARK.json`` entry; its
    ``reduced`` and ``assumed`` are lists of non-empty strings (what they
    say is for the reviewer and ``PERF.md``); its architecture has a file."""
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("reduced", "assumed"):
        assert isinstance(cfg[key], list)
        assert all(isinstance(v, str) and v for v in cfg[key])
    for fn in ("reference", "drawn", "port_model", "flops", "launch_checks"):
        assert callable(getattr(harness.architecture(cfg), fn))
    # the weights are the seed's alone: the process's generator moves none
    from perfbench import program
    states = []
    for global_seed in (1, 2):
        with torch.random.fork_rng():
            torch.manual_seed(global_seed)
            states.append(program.draw_weights(cfg, 7, "cpu"))
    assert states[0].keys() == states[1].keys()
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def check_workload(entry: dict) -> None:
    """A cell's file agrees with its ``BENCHMARK.json`` entry, and its
    configuration and traffic kind are found by name."""
    cell, cfg, mix = harness.load_cell(entry["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == entry[k]
    assert cfg["name"] == entry["config"]
    harness.traffic_kind(mix["kind"])
    assert entry["name"].startswith(entry["config"] + ".")


def test_benchmark_json_matches_the_files():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        check_config(c)
    for w in BENCH["workloads"]:
        check_workload(w)


def test_every_metric_has_its_reader():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        path = os.path.join(harness.HERE, "metrics", f"{m['name']}.py")
        mod = harness.load_module(path, f"t_{m['name']}")
        assert callable(mod.read)
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved["workloads"])
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_cells_report_setup_and_another_end_to_end_metric():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in BENCH["end_to_end"]
                 if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in names and len(names) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch):
    from perfbench import run
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (root / "perfbench/traffic/eval_640x512x3.json").write_text(json.dumps(
        {**harness.load_json("traffic", "eval_1152x864x5.json"),
         "img_wh": [640, 512], "n_views": 3, "focal": 600.0}))
    (root / "perfbench/workloads/casmvsnet.eval_640x512x3.json").write_text(
        json.dumps({**harness.load_json(
            "workloads", "casmvsnet.eval_1152x864x5.json"),
            "traffic": "eval_640x512x3"}))
    (root / "perfbench/metrics/maps_in_window.py").write_text(
        "def read(run):\n    return float(run['units'])\n")
    bench["per_layer"].append({"name": "maps_in_window", "unit": "maps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "maps_per_s",
                               "workloads": ["casmvsnet.eval_1152x864x5",
                                             "casmvsnet.eval_640x512x3"]})
    for m in bench["end_to_end"]:
        if "maps_per_s" == m["name"] or "map_ms_p95" == m["name"]:
            m["workloads"].append("casmvsnet.eval_640x512x3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", str(root / "perfbench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    cell, cfg, mix = harness.load_cell("casmvsnet.eval_640x512x3")
    assert mix["img_wh"] == [640, 512] and cfg["name"] == "casmvsnet"
    res = {"trace": {"window_s": 1.0, "busy_s": 0.5, "kernels": {}},
           "chips": 1, "units": 7}
    got = run.per_layer("casmvsnet.eval_640x512x3", cell, cfg, mix, res,
                        "NVIDIA H100 80GB HBM3", (640, 512))
    # listed by data: each metric only in the cells its list names
    assert got["maps_in_window"]["value"] == 7.0
    assert "idle_pct.eval" not in got
    got = run.per_layer("casmvsnet.eval_1152x864x5", cell, cfg, mix, res,
                        "NVIDIA H100 80GB HBM3", (640, 512))
    assert got["maps_in_window"]["value"] == 7.0
    assert got["idle_pct.eval"]["value"] == pytest.approx(50.0)


TOY = '''"""A toy architecture: CasMVSNet with one more drawn Linear, which the
forward does not use and the port does not have, and one more launch
check."""
import torch
import torch.nn as nn

from perfbench.architectures import casmvsnet

HEAD = (32, 16)


def reference(config):
    model = casmvsnet.reference(config)
    model.head = nn.Linear(*HEAD)
    with torch.no_grad():
        model.head.bias.zero_()
    return model


def drawn(model):
    return casmvsnet.drawn(model) + [("head.weight", 0.125)]


def port_model(config, weights, device, dtype=None):
    own = {k: v for k, v in weights.items() if not k.startswith("head.")}
    return casmvsnet.port_model(config, own, device, dtype)


def flops(config, img_wh, n_views, batch, train=False):
    return casmvsnet.flops(config, img_wh, n_views, batch, train) + \\
        2 * batch * HEAD[0] * HEAD[1]


def launch_checks(config, train):
    return {**casmvsnet.launch_checks(config, train),
            "prob_launch_gap": ("prob_conv_cuda", config["levels"])}
'''


def test_a_new_architecture_needs_only_new_files(tmp_path, monkeypatch,
                                                 request):
    """A toy architecture, its configuration (``arch``, ``assumed`` not
    empty), a mix and a cell, written into a copy: the eval loop runs it on
    the CPU with ``correct`` true, ``mfu.eval`` reads the toy's count, and
    the files test takes its configuration."""
    from perfbench import compare, program, run
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "perfbench/architectures/toy.py").write_text(TOY)
    cfg = {**harness.load_json("configs", "casmvsnet.json"), "name": "toy",
           "arch": "toy", "source": "https://example.org/toy",
           "assumed": ["head 32 -> 16, a Linear the toy adds"]}
    (root / "perfbench/configs/toy.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/eval_640x512x3.json").write_text(json.dumps(
        {**harness.load_json("traffic", "eval_1152x864x5.json"),
         "img_wh": [640, 512], "n_views": 3, "focal": 600.0}))
    cell = {**harness.load_json("workloads",
                                "casmvsnet.eval_1152x864x5.json"),
            "config": "toy", "traffic": "eval_640x512x3"}
    cell["limits"]["prob_launch_gap"] = 0.0
    (root / "perfbench/workloads/toy.eval_640x512x3.json").write_text(
        json.dumps(cell))
    bench = json.loads(json.dumps(BENCH))
    entry = {"name": "toy", "source": cfg["source"],
             "file": "perfbench/configs/toy.json", "reduced": [],
             "why": "a toy"}
    bench["configs"].append(entry)
    bench["workloads"].append({k: cell[k] for k in ("config", "traffic",
                                                    "chips", "why")}
                              | {"name": "toy.eval_640x512x3"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "casmvsnet.eval_1152x864x5" in m.get("workloads", []):
            m["workloads"].append("toy.eval_640x512x3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", str(root / "perfbench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    # the copy's architectures are found first; the toy leaves with the copy
    pkg = sys.modules["perfbench.architectures"]
    monkeypatch.setattr(pkg, "__path__",
                        [str(root / "perfbench/architectures"), *pkg.__path__])
    monkeypatch.setattr(pkg, "toy", None, raising=False)
    request.addfinalizer(
        lambda: sys.modules.pop("perfbench.architectures.toy", None))

    check_config(entry)
    check_workload(bench["workloads"][-1])
    toy = harness.architecture(cfg)
    assert toy.__file__ == str(root / "perfbench/architectures/toy.py")
    w = program.draw_weights(cfg, 5, "cpu")
    assert w["head.weight"].shape == (16, 32)
    assert 0.08 < float(w["head.weight"].std()) < 0.17
    # the extra check is declared, and held as any launch check is
    gaps = compare.launch_gaps(toy.launch_checks(cfg, train=False),
                               {"cost_volume_cuda": 0, "prob_conv_cuda": 0},
                               {"cost_volume_cuda": 6, "prob_conv_cuda": 5}, 2)
    assert gaps == {"k1_launch_gap": 0.0, "prob_launch_gap": 0.5}

    r = harness.run_cell("toy.eval_640x512x3", [3_000_000_019], 0.3, False,
                         torch.device("cpu"), size=(64, 64))[0]
    assert compare.passed(r["checks"]), r["checks"]
    assert r["attempted"] > 0

    res = {"trace": {"window_s": 2.0, "busy_s": 1.0, "kernels": {}},
           "chips": 1, "units": 10}
    card = "NVIDIA H100 80GB HBM3"
    _, _, mix = harness.load_cell("toy.eval_640x512x3")
    got = run.per_layer("toy.eval_640x512x3", cell, cfg, mix, res, card,
                        (640, 512))
    count = toy.flops(cfg, (640, 512), 3, 1)
    assert count == harness.architecture({}).flops(cfg, (640, 512), 3, 1) \
        + 2 * 32 * 16
    assert got["mfu.eval"]["value"] == pytest.approx(
        100.0 * count * 10 / 2.0 / 989e12, rel=1e-12)
