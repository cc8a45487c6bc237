"""The port's measurement entry points on the CPU: ``bench_torch.py`` and
``scripts/{flops_report,profile_stages,profile_bwd,profile_train_step,
profile_eval_res}_torch.py``, each through its ``main`` at a small size
with ``--device cpu``, printing the JAX script's labels; without a card
each raises; and ``chip_smoke.py``'s phases 51-53 rehearsed on the CPU
(the card's calls stubbed, no kernel launches expected, every other check
of the phases run)."""
import json
import math
import os

import pytest
import torch

import bench
import bench_torch
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--H", "64", "--W", "96"]
SCRIPTS = ["flops_report_torch", "profile_stages_torch", "profile_bwd_torch",
           "profile_train_step_torch", "profile_eval_res_torch"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script(name: str):
    if name == "bench_torch":
        return bench_torch
    return chip_smoke.script(name)


def jax_source(name: str) -> str:
    path = os.path.join(REPO, "bench.py" if name == "bench" else
                        os.path.join("scripts", f"{name}.py"))
    with open(path) as f:
        return f.read()


def assert_labels(out: str, jax_script: str, labels) -> None:
    """Each label is the JAX script's and is printed: a string, or a pair
    (the JAX script's format string, the port's line at this size)."""
    src = jax_source(jax_script)
    for label in labels:
        template, printed = label if isinstance(label, tuple) else (label,
                                                                    label)
        assert template in src, (jax_script, template)
        assert printed in out, printed


def test_bench_torch_smoke_line_is_bench_py_s(capsys):
    res = bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    last = json.loads(lines[-1])
    bench.emit(1.0)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(last) == list(want)
    assert (last["metric"], last["unit"]) == (want["metric"], want["unit"])
    assert last["value"] == round(res["best"], 3) > 0
    assert last["vs_baseline"] == round(res["best"] / 4.0, 3)
    assert abs(last["vs_baseline"] - last["value"] / 4.0) <= 5e-4 + 1e-12
    assert list(res["batches"]) == [1] and res["iters"] == 3


def test_flops_report_torch_on_cpu(capsys):
    res = script("flops_report_torch").main(SMALL + ["--iters", "2",
                                                      "--batch", "1", "2"])
    out = capsys.readouterr().out
    assert_labels(out, "flops_report", ["GFLOP/fwd", " maps/s", "TFLOP/s"])
    assert "batch=1 96x64x3: 1.891 GFLOP/fwd (convolutions 1.838" in out
    assert "share of peak: not measured on the CPU" in out
    assert sorted(res) == [1, 2]
    assert res[2]["conv_total"] == 2 * res[1]["conv_total"] == 2 * 1837891584
    assert all(r["ms"] > 0 for r in res.values())


def test_profile_stages_torch_on_cpu(capsys):
    res = script("profile_stages_torch").main(SMALL + ["--batch", "1",
                                                        "--iters", "2"])
    out = capsys.readouterr().out
    assert_labels(out, "profile_stages", [
        ("feature {B*V}x{H}x{W}", "feature 3x64x96"),
        ("warp+cost L{l} D{D} {h}x{w} C{C}", "warp+cost L2 D48 16x24 C32"),
        ("warp+cost L{l} D{D} {h}x{w} C{C}", "warp+cost L0 D8 64x96 C8"),
        ("costreg L{l} D{D} {h}x{w} C{Cin}", "costreg L1 D32 32x48 C16"),
        "sum of stages", ("FULL cascade {B}x{V}x{H}x{W}",
                          "FULL cascade 1x3x64x96"), "maps/s = "])
    assert "softmax+regression L0 D8 64x96" in out
    assert len(res) == 13 and all(v > 0 for v in res.values())
    stages = [v for k, v in res.items() if k.startswith(
        ("feature", "warp", "costreg", "softmax"))]
    assert len(stages) == 10
    assert res["sum of stages"] == pytest.approx(sum(stages))


def test_profile_bwd_torch_on_cpu(capsys):
    res = script("profile_bwd_torch").main(SMALL + ["--batch", "1",
                                                     "--iters", "2"])
    out = capsys.readouterr().out
    labels = ["feature fwd+bwd"]
    for l in (2, 1, 0):
        labels += [("warp+cost L{l} fwd+bwd", f"warp+cost L{l} fwd+bwd"),
                   ("costreg L{l} fwd+bwd", f"costreg L{l} fwd+bwd")]
    assert_labels(out, "profile_bwd", labels)
    assert sorted(res) == sorted(p if isinstance(p, str) else p[1]
                                 for p in labels)
    assert all(v > 0 for v in res.values())


@pytest.mark.parametrize("sampling", ["auto", "quad"])
def test_profile_train_step_torch_on_cpu(capsys, sampling):
    res = script("profile_train_step_torch").main(
        SMALL + ["--iters", "2", "--sampling", sampling])
    out = capsys.readouterr().out
    assert_labels(out, "profile_train_step", [
        ("train_step sampling={args.sampling}",
         f"train_step sampling={sampling}: "), " samples/s)"])
    assert res["ms"] > 0 and res["peak_gib"] is None
    # convolutions forward and backward: about three forwards' worth
    assert 2.5 < sum(res["conv"].values()) / (2 * 1837891584) < 3.0


def test_profile_eval_res_torch_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("ER_ORDER", "auto,quad")
    monkeypatch.setenv("ER_ITERS", "2")
    res = script("profile_eval_res_torch").main(["--device", "cpu", "--H",
                                                  "64", "--W", "64"])
    out = capsys.readouterr().out
    template = "eval-res forward {W}x{H} {V} views [{sampling}]: "
    assert_labels(out, "profile_eval_res", [
        (template, "eval-res forward 64x64 5 views [auto]: "),
        (template, "eval-res forward 64x64 5 views [quad]: "),
        "ms/view (", " views/s; reference ", "2080Ti: 756 ms/view -> "])
    assert sorted(res) == ["auto", "quad"]
    assert all(r["ms"] > 0 for r in res.values())


@pytest.mark.parametrize("name", ["bench_torch"] + SCRIPTS)
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_entry_points_raise_without_a_card(monkeypatch, name, argv):
    """Each runs on the card by default and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main(argv)


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_chip_smoke_measure_phases_rehearse_on_cpu(monkeypatch, capsys):
    """Phases 51-53 end to end on the CPU at 96x64 (the eval view 64x64x5),
    bench_torch in its smoke mode, one timed call a script."""
    for name, value in (("DEVICE", "cpu"), ("IMG_WH", (96, 64)),
                        ("EVAL_WH", (64, 64)), ("DEFAULT_FWD", {}),
                        ("DEFAULT_STEP", {}), ("QUAD_FWD", {}),
                        ("QUAD_STEP", {}), ("BENCH_BATCHES", (1,)),
                        ("BENCH_TOL", math.inf), ("FLOPS_BATCHES", (1, 2)),
                        ("CONV_FLOPS_B1", 1837891584),
                        ("MEASURE_ITERS", dict.fromkeys(
                            chip_smoke.MEASURE_ITERS, 1))):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, value in (("synchronize", lambda *a: None), ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, value)
    paths = chip_smoke.measure_path("cpu rehearsal", 1.0)
    assert set(paths) == {"bench", "flops", "stages", "bwd", "train_step",
                          "train_step_quad", "eval_res"}
    assert all(n == 0 for counts in paths.values() for n in counts.values())
    out = capsys.readouterr().out
    for what in ('bench_torch: {"metric": "depth_maps_per_sec_per_chip_'
                 '640x512_3views"',
                 "bench_torch phase: batches [1]",
                 "flops phase: convolutions B=1 counted 1837891584",
                 "stages B=2 96x64x3: sum of stages",
                 "feature fwd+bwd",
                 "train_step sampling=quad: ",
                 "eval-res forward 64x64 5 views [quad]",
                 "profile_eval_res_torch: launches",
                 "measurement path (phases 51-53)"):
        assert what in out, what
