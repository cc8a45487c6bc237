"""Every configuration, cell, traffic mix and metric is found by name, and
``BENCHMARK.json`` agrees with the files; a new cell, mix and metric are
picked up by adding files alone."""
from __future__ import annotations

import json
import os
import shutil

import pytest

from perfbench import harness

BENCH = harness.benchmark()


def test_benchmark_json_matches_the_files():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == [] and cfg["assumed"] == []
    for w in BENCH["workloads"]:
        cell, cfg, mix = harness.load_cell(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k]
        assert cfg["name"] == w["config"]
        harness.traffic_kind(mix["kind"])
        assert w["name"].startswith(w["config"] + ".")


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
