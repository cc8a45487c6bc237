"""TPU kernels #10 and #11 on the card: TPU kernel #3 for V=3 swept by
block shape, and the lane-prefix copy, the probe of the card's rate for a
strided read.

Counterpart of ``scripts/probe_epi3.py`` at its L1 config (B=2, D=32,
256x320, C=16; bf16 rows and ref from ``randn``, f32 weights from ``rand``,
numpy RandomState(0), drawn in the probe's order):

- #10, ``make_var``: the variance epilogue with two source views written
  out, swept by its tile T in {1024, 4096, 8192, 16384}; here
  ``kernels/probes.py::variance_v3_cuda`` swept by threads per block in
  {64, 128, 256, 512, 1024}, beside #3 (``variance_epilogue_cuda``, 128
  threads) as the baseline. The probe's VMEM limit and dimension semantics
  have no counterpart on the card.
- #11, ``make_copy``: out = rows[..., :C] of the first view's (..., 4C)
  rows, at T in {1024, 8192}; here ``lane_prefix_copy_cuda`` at 1024 and
  8192 rows per block, beside ``rows[..., :C].contiguous()`` as the
  library call.

Plain versions: :func:`plain_variance_v3` (``ops/cost_epilogue.py::
plain_variance_epilogue`` held to two source views) and
:func:`plain_lane_prefix_copy`. :func:`variance_v3` and
:func:`lane_prefix_copy` take a CUDA tensor to the kernel and a CPU tensor
to the plain version.

    python -m casmvsnet_pl_tpu_torch.probes.epi3
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.cost_epilogue import variance_epilogue_cuda
from ..kernels.probes import (COPY_ROWS_PER_BLOCK, V3_THREADS,
                              lane_prefix_copy_cuda, variance_v3_cuda)
from ..ops.cost_epilogue import plain_variance_epilogue
from . import common

Tensor = torch.Tensor

L1 = (2, 32, 256 * 320, 16)     # B, D, hw, C
EPI_TOL = 1e-5


def plain_variance_v3(ref: Tensor, rows: Tensor, ws: Tensor) -> Tensor:
    """The variance over ref and two source views: rows (B, 2, D, hw, 4C),
    ws (B, 2, D, hw, 4) f32, ref (B, hw, C) -> (B, D, hw, C) in ref's
    dtype."""
    if rows.shape[1] != 2:
        raise ValueError(f"two source views, got rows {tuple(rows.shape)}")
    return plain_variance_epilogue(ref, rows, ws)


def variance_v3(ref: Tensor, rows: Tensor, ws: Tensor,
                threads: int = 128) -> Tensor:
    """TPU kernel #10: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if ref.is_cuda:
        return variance_v3_cuda(ref, rows, ws, threads)
    return plain_variance_v3(ref, rows, ws)


def plain_lane_prefix_copy(rows: Tensor) -> Tensor:
    """(..., 4C) -> the first tap block (..., C), a new tensor."""
    return rows.unflatten(-1, (4, rows.shape[-1] // 4))[..., 0, :].clone()


def lane_prefix_copy(rows: Tensor, rows_per_block: int = 1024) -> Tensor:
    """TPU kernel #11, dispatched as :func:`variance_v3`."""
    if rows.is_cuda:
        return lane_prefix_copy_cuda(rows, rows_per_block)
    return plain_lane_prefix_copy(rows)


def inputs(device, shape=None):
    """(ref (B, hw, C), rows (B, 2, D, hw, 4C), ws (B, 2, D, hw, 4)), f32,
    from RandomState(0) in the probe's order: both views' rows, both
    views' weights, then ref; ``shape`` (B, D, hw, C), by default L1."""
    B, D, hw, C = shape or L1
    rng = np.random.RandomState(0)
    rows = [rng.randn(B, D, hw, 4 * C).astype(np.float32) for _ in range(2)]
    ws = [rng.rand(B, D, hw, 4).astype(np.float32) for _ in range(2)]
    ref = rng.randn(B, hw, C).astype(np.float32)

    def stack(arrs):
        return torch.stack([torch.from_numpy(a).to(device) for a in arrs], 1)

    return torch.from_numpy(ref).to(device), stack(rows), stack(ws)


def run_copy(data, card_name: str) -> list:
    """#11 at 1024 and 8192 rows per block on the first view's bf16 rows:
    bit-exact against the plain version (f32 and bf16), then timed beside
    the library call; returns the timed results."""
    _, rows, _ = data
    results = []
    r0f = rows[:, 0].contiguous()
    r0 = r0f.to(torch.bfloat16)
    C = r0.shape[-1] // 4
    need = 2 * r0.numel() // 4 * r0.element_size()
    whole = r0.numel() * r0.element_size() + need // 2
    for rpb in COPY_ROWS_PER_BLOCK:
        for t in (r0f, r0):
            common.check_exact(f"lane_prefix_copy_cuda rows_per_block={rpb} "
                               f"{t.dtype}", lane_prefix_copy_cuda(t, rpb),
                               plain_lane_prefix_copy(t))
        results.append(common.timed(
            lane_prefix_copy_cuda.name, f"rows_per_block={rpb}",
            f"bf16 rows {tuple(r0.shape)} -> C={C} rows_per_block={rpb}",
            lambda: lane_prefix_copy_cuda(r0, rpb),
            lambda: plain_lane_prefix_copy(r0), (need, 0.0), 0.0, card_name,
            (50, 10), lambda: r0[..., :C].contiguous(),
            note=f"whole-row bound {whole / 3.35e9!r} ms ({whole / 1e6!r} "
                 f"MB); "))
    return results


def run_var(data, card_name: str) -> list:
    """#10 at every block size: f32 against the plain version (<= 1e-5),
    bf16 within 1 bf16 ulp of the plain f32 result on the same bf16 inputs;
    then timed in bf16 beside #3; returns the timed results."""
    ref, rows, ws = data
    plain = plain_variance_v3(ref, rows, ws)
    errs = {}
    for threads in V3_THREADS:
        errs[threads] = common.check_close(
            f"variance_v3_cuda threads={threads} f32",
            variance_v3_cuda(ref, rows, ws, threads), plain, EPI_TOL)
    del plain
    rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
    plain = plain_variance_v3(rb.float(), rowsb.float(), ws)
    for threads in V3_THREADS:
        common.check_ulp(f"variance_v3_cuda threads={threads} bf16",
                         variance_v3_cuda(rb, rowsb, ws, threads), plain)
    del plain
    print(f"variance_v3 probe: f32 max_abs_err by threads {errs} (bound "
          f"{EPI_TOL}), bf16 within 1 ulp", flush=True)
    B, S, D, hw, C4 = rowsb.shape
    work = common.epilogue_work(B, S, D, hw, C4 // 4, 1, 2)
    label = f"bf16 rows {tuple(rowsb.shape)}"
    common.timed(variance_epilogue_cuda.name, "baseline (#3)", label,
                 lambda: variance_epilogue_cuda(rb, rowsb, ws),
                 lambda: plain_variance_v3(rb, rowsb, ws), work, 0.0,
                 card_name, (20, 3))
    return [common.timed(
        variance_v3_cuda.name, f"threads={threads}",
        f"{label} threads={threads}",
        lambda: variance_v3_cuda(rb, rowsb, ws, threads),
        lambda: plain_variance_v3(rb, rowsb, ws), work, errs[threads],
        card_name, (20, 3)) for threads in V3_THREADS]


def main(device="cuda", card_name: str | None = None) -> list:
    card_name = card_name or common.card()
    data = inputs(device)
    return run_copy(data, card_name) + run_var(data, card_name)


if __name__ == "__main__":
    main()
