"""The card check printed on standard error before every window: the card's
name and power limit, torch, CUDA, nvcc, and the rate of one 4096^3 bf16
matmul (a copy of ``bench_torch.py::matmul_rate``: the median of 32 calls
timed with CUDA events)."""
from __future__ import annotations

import shutil
import statistics
import subprocess
import sys

import torch

MATMUL_N = 4096


def _run(cmd: list[str], last: bool = False) -> str:
    """The command's output on one line (``last``: its last line only)."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not run: {e}"
    lines = (out.stdout.strip() or out.stderr.strip()).splitlines()
    if not lines:
        return f"exit {out.returncode}"
    return lines[-1] if last else " | ".join(lines)


def matmul_rate(device, n: int = MATMUL_N, iters: int = 32) -> float:
    """FLOP/s of one n^3 bf16 ``torch.matmul`` (median of ``iters``
    calls after 2, CUDA events)."""
    a = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    for _ in range(2):
        torch.matmul(a, a)
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.matmul(a, a)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e-3)
    return 2 * n ** 3 / statistics.median(times)


def report(device) -> str:
    """Print the card check on stderr; returns the card's name."""
    name = torch.cuda.get_device_name(device)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    nvcc = _run([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
                 "--version"], last=True)
    rate = matmul_rate(device)
    print(f"card: {name}; nvidia-smi {smi}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; nvcc {nvcc}; "
          f"matmul {MATMUL_N}^3 bf16 {rate / 1e12!r} TFLOP/s; cards "
          f"{torch.cuda.device_count()}", file=sys.stderr, flush=True)
    return name
