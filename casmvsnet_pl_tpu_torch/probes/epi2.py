"""TPU kernel #9 on the card: TPU kernel #3 with several depths per thread.

Counterpart of ``scripts/probe_epi2.py``: at its two configs (B=2, V=3;
L1 D=32, 256x320, C=16; L2 D=48, 128x160, C=32), with ``rand`` features
from numpy RandomState(0), the translation projection (identity with
``proj[..., 0, 3] = 3.0``) and depths ``425 + 2.65 d``, it gathers the
packed-quad rows, times the gather alone and #3 alone, then the variance
epilogue with Dblk depths per grid step. The gather step here is the
port's ``ops/plane_sweep.py::quad_rows`` (the TPU script's
``_gather_rows_all_views`` no longer exists). ``kernels/probes.py::
variance_dblk_cuda`` walks dblk in {1, 4, 8, D} depths per thread, the
counterpart of the probe's (Dblk, T) sweep.

Plain version: :func:`plain_variance_dblk` (``ops/cost_epilogue.py::
plain_variance_epilogue``; the depth blocking does not change the
function). :func:`variance_dblk` takes a CUDA tensor to the kernel and a
CPU tensor to the plain version.

    python -m casmvsnet_pl_tpu_torch.probes.epi2
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.cost_epilogue import variance_epilogue_cuda
from ..kernels.probes import variance_dblk_cuda
from ..ops.cost_epilogue import plain_variance_epilogue
from . import common
from .epi3 import EPI_TOL

Tensor = torch.Tensor

B, V = 2, 3
LEVELS = ((1, 32, 256, 320, 16), (2, 48, 128, 160, 32))  # l, D, h, w, C
DBLKS = (1, 4, 8, None)    # None: all D depths in one thread


def plain_variance_dblk(ref: Tensor, rows: Tensor, ws: Tensor,
                        dblk: int | None = None) -> Tensor:
    """The variance epilogue (shapes as ``plain_variance_epilogue``);
    ``dblk`` only sets the kernel's blocking."""
    return plain_variance_epilogue(ref, rows, ws)


def variance_dblk(ref: Tensor, rows: Tensor, ws: Tensor,
                  dblk: int | None = None) -> Tensor:
    """TPU kernel #9: the CUDA kernel for a CUDA tensor (dblk None: all
    depths), the plain version for a CPU one."""
    if ref.is_cuda:
        return variance_dblk_cuda(ref, rows, ws, dblk or rows.shape[2])
    return plain_variance_dblk(ref, rows, ws, dblk)


def level_inputs(rng, D: int, h: int, w: int, C: int, device):
    """The probe's features (B, V, h, w, C) f32 from ``rng.rand``, its
    projections (B, V-1, 3, 4) and depth windows (B, D, h, w)."""
    feats = torch.from_numpy(rng.rand(B, V, h, w, C).astype(np.float32))
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(
        np.float32), (B, V - 1, 1, 1))
    proj[..., 0, 3] = 3.0
    dv = ((425.0 + 2.65 * np.arange(D, dtype=np.float32))[None, :, None, None]
          * np.ones((B, D, h, w), np.float32))
    return (feats.to(device), torch.from_numpy(proj).to(device),
            torch.from_numpy(dv).to(device))


def main(device="cuda", card_name: str | None = None) -> list:
    """Per level: every dblk against the plain version in f32 (<= 1e-5)
    and bf16 (within 1 bf16 ulp of the plain f32 result), then the gather,
    #3 and every dblk timed in bf16; returns the timed results."""
    from ..ops import quad_rows
    card_name = card_name or common.card()
    rng = np.random.RandomState(0)
    results = []
    for l, D, h, w, C in LEVELS:
        feats, proj, dv = level_inputs(rng, D, h, w, C, device)
        ref, rows, ws, _ = quad_rows(feats, proj, dv)
        plain = plain_variance_dblk(ref, rows, ws)
        errs = {}
        for dblk in DBLKS:
            errs[dblk] = common.check_close(
                f"variance_dblk_cuda L{l} dblk={dblk or D} f32",
                variance_dblk_cuda(ref, rows, ws, dblk or D), plain, EPI_TOL)
        del ref, rows, ws, plain
        fb = feats.to(torch.bfloat16)
        ref, rows, ws, _ = quad_rows(fb, proj, dv)
        plain = plain_variance_dblk(ref.float(), rows.float(), ws)
        for dblk in DBLKS:
            common.check_ulp(f"variance_dblk_cuda L{l} dblk={dblk or D} bf16",
                             variance_dblk_cuda(ref, rows, ws, dblk or D),
                             plain)
        del plain
        print(f"variance_dblk probe L{l}: f32 max_abs_err by dblk "
              f"{ {dblk or D: e for dblk, e in errs.items()} } (bound "
              f"{EPI_TOL}), bf16 within 1 ulp", flush=True)
        t = common.cuda_ms(lambda: quad_rows(fb, proj, dv), 5)
        print(f"probe L{l} gathers only (quad_rows, bf16, B={B}, 2 views): "
              f"{t!r} ms [{card_name}]", flush=True)
        work = common.epilogue_work(B, V - 1, D, h * w, C, 1, 2)
        label = f"L{l} bf16 rows {tuple(rows.shape)}"
        common.timed(variance_epilogue_cuda.name, "baseline (#3)", label,
                     lambda: variance_epilogue_cuda(ref, rows, ws),
                     lambda: plain_variance_dblk(ref, rows, ws), work, 0.0,
                     card_name, (20, 3))
        for dblk in DBLKS:
            results.append(common.timed(
                variance_dblk_cuda.name, f"dblk={dblk or 'D'}",
                f"{label} dblk={dblk or D}",
                lambda: variance_dblk_cuda(ref, rows, ws, dblk or D),
                lambda: plain_variance_dblk(ref, rows, ws), work,
                errs[dblk], card_name, (20, 3)))
        del feats, fb, ref, rows, ws
    return results


if __name__ == "__main__":
    main()
