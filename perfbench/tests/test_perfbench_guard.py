"""The import guard, by whole top-level names, and what a run does without
a card or without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness
from perfbench.run import forbidden_modules

RUN = os.path.join(harness.HERE, "run.py")


def test_guard_compares_whole_top_level_names():
    mods = ["torch", "casmvsnet_pl_tpu_torch", "casmvsnet_pl_tpu_torch.ops",
            "jaxtyping", "flaxen", "perfbench.run"]
    assert forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "casmvsnet_pl_tpu", "casmvsnet_pl_tpu.models"]
    assert forbidden_modules(mods + bad) == sorted(bad)


def test_a_cpu_run_loads_no_jax():
    """The harness, the program and the reference through a whole small
    run on the CPU, in a fresh process, then the guard over its modules."""
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from perfbench.harness import run_cell\n"
        "from perfbench.run import forbidden_modules\n"
        "r = run_cell('casmvsnet.eval_1152x864x5', [9], 0.2, False,\n"
        "             torch.device('cpu'), size=(64, 64))[0]\n"
        "print(forbidden_modules(), sorted(r['checks']))\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "[] ['conf_vs_bf16', 'depth_p99_vs_bf16', 'depth_vs_bf16']"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "casmvsnet.eval_1152x864x5",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "casmvsnet.train_640x512x3_b2", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
