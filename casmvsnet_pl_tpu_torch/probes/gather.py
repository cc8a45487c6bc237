"""TPU kernel #13 on the card: which gather forms a kernel takes, and at
what rate.

Counterpart of ``scripts/probe_gather.py``. The TPU probe asked which
in-kernel gather forms Mosaic lowers: a row gather ``out[i, :] =
feat[idx[i], :]`` written as take, take_along_axis, advanced indexing, a
one-hot matmul and a loop of dynamic-slice rows, and a lane gather
``out[r, j] = featT[r, idx[j]]``. On the card every form is a kernel that
one writes; the question becomes which form moves rows fastest. The three
Hopper forms of the row gather (``kernels/probes.py``: ``ldg``,
``cp_async``, ``bulk``; the tensor-map gather is sm_100 and has no form
here) and the lane gather run at the probe's shapes (feat (8192, 128) f32,
idx (256,); featT (8, 1024) f32, idx (128,)), and the row gather also at
the quad route's own gather: ``ops/plane_sweep.py::quad_rows`` at the
default config's B=1 levels, whose ``index_select`` is the library call.

The plain versions: :func:`plain_row_gather` (advanced indexing, the
counterpart of ``feat_ref[idx_ref[:], :]``) and :func:`plain_lane_gather`;
:func:`row_gather_forms` computes the probe's five forms in PyTorch and
:func:`check_forms` holds them equal. :func:`row_gather` and
:func:`lane_gather` take a CUDA tensor to a kernel and a CPU tensor to the
plain version.

    python -m casmvsnet_pl_tpu_torch.probes.gather
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.probes import (lane_gather_cuda, row_gather_bulk_cuda,
                              row_gather_cp_async_cuda, row_gather_ldg_cuda)
from . import common

Tensor = torch.Tensor

FORMS = {"ldg": row_gather_ldg_cuda, "cp_async": row_gather_cp_async_cuda,
         "bulk": row_gather_bulk_cuda}
PROBE_ROWS, PROBE_LANES, PROBE_N = 64 * 128, 128, 256   # feat, idx
LANE_ROWS, LANE_COLS, LANE_N = 8, 1024, 128              # featT, idx_lane


def plain_row_gather(table: Tensor, idx: Tensor) -> Tensor:
    """table (n, R), idx (N,) int64 -> table[idx] (N, R)."""
    return table[idx]


def plain_lane_gather(featT: Tensor, idx: Tensor) -> Tensor:
    """featT (R, L), idx (J,) int64 -> featT[:, idx] (R, J)."""
    return featT[:, idx]


def row_gather_forms(table: Tensor, idx: Tensor) -> dict:
    """The TPU probe's row-gather forms in PyTorch, by its kernels' names:
    take (``index_select``), take_along_axis, advanced indexing, the
    one-hot product and a loop of one-row slices. The one-hot product is
    exact: each output sums one 1 * value."""
    n, R = table.shape
    onehot = F.one_hot(idx, n).to(table.dtype)
    return {
        "k_take": table.index_select(0, idx),
        "k_tala": torch.take_along_dim(table, idx[:, None].expand(-1, R), 0),
        "k_adv": plain_row_gather(table, idx),
        "k_onehot": onehot @ table,
        "k_dynslice": torch.cat([table.narrow(0, int(i), 1) for i in idx]),
    }


def check_forms(table: Tensor, idx: Tensor) -> dict:
    """:func:`row_gather_forms`, all equal bit for bit, or raise."""
    forms = row_gather_forms(table, idx)
    for name, out in forms.items():
        common.check_exact(f"row gather form {name}", out, forms["k_adv"])
    return forms


def row_gather(table: Tensor, idx: Tensor, form: str = "ldg") -> Tensor:
    """TPU kernel #13's row gather: the CUDA kernel of ``form`` for a CUDA
    tensor, the plain version for a CPU one."""
    if table.is_cuda:
        return FORMS[form](table, idx)
    return plain_row_gather(table, idx)


def lane_gather(featT: Tensor, idx: Tensor) -> Tensor:
    """TPU kernel #13's lane gather, dispatched as :func:`row_gather`."""
    if featT.is_cuda:
        return lane_gather_cuda(featT, idx)
    return plain_lane_gather(featT, idx)


def probe_inputs(device):
    """The TPU probe's arrays: feat (8192, 128) and featT (8, 1024) from
    RandomState(0), idx (256,) and idx_lane (128,) from RandomState(1)."""
    feat = np.random.RandomState(0).rand(PROBE_ROWS, PROBE_LANES)
    idx = np.random.RandomState(1).randint(0, PROBE_ROWS, (PROBE_N,))
    featT = np.random.RandomState(0).rand(LANE_ROWS, LANE_COLS)
    idx_lane = np.random.RandomState(1).randint(0, LANE_COLS, (LANE_N,))
    return tuple(torch.from_numpy(a).to(device) for a in (
        feat.astype(np.float32), idx.astype(np.int64),
        featT.astype(np.float32), idx_lane.astype(np.int64)))


def quad_gather_inputs(device, img_wh=common.IMG_WH, seed: int = 0):
    """Per level of the default config (B=1, coarse to fine): ((level, C,
    D, h, w), the bf16 ``pack_quad`` tables of the two source views
    flattened to (2 (h+1) (w+1), 4C), the row indices ``quad_rows`` makes
    (2 D h w,), and the rows its ``index_select`` gathered), on the plane
    scene's rig, features from RandomState(seed)."""
    from ..ops import pack_quad, quad_rows
    rng = np.random.RandomState(seed)
    inputs = common.plane_levels(device, img_wh=img_wh)
    for lvl in common.default_levels(img_wh):
        l, C, D, h, w = lvl
        proj, dv = inputs[l]
        feats = torch.from_numpy(rng.rand(1, 3, h, w, C).astype(np.float32)
                                 ).to(device).to(torch.bfloat16)
        _, rows, _, idx = quad_rows(feats, proj, dv)
        table = pack_quad(feats[:, 1:]).reshape(-1, 4 * C)
        yield lvl, table, idx, rows.reshape(-1, 4 * C)


def gather_work(table: Tensor, N: int) -> tuple[float, float]:
    """(bytes, operations) of a row gather of N rows: the table and the
    int64 indices read once, the rows written once."""
    row = table.shape[1] * table.element_size()
    return table.shape[0] * row + N * 8 + N * row, 0.0


def main(device="cuda", card_name: str | None = None,
         img_wh=common.IMG_WH) -> list:
    """Check every form at the probe's shapes and the quad route's gather
    (at ``img_wh``), then time them; returns the timed results (the row
    forms at the quad gather, summed over its levels by a caller; the lane
    gather at the probe's shape)."""
    card_name = card_name or common.card()
    feat, idx, featT, idx_lane = probe_inputs(device)
    check_forms(feat, idx)
    want = plain_row_gather(feat, idx)
    for form, kernel in FORMS.items():
        for dtype in (torch.float32, torch.bfloat16):
            t = feat.to(dtype)
            common.check_exact(f"{kernel.name} {dtype} probe shape",
                               kernel(t, idx), want.to(dtype))
    lane_err = common.check_exact("lane_gather_cuda probe shape",
                                  lane_gather_cuda(featT, idx_lane),
                                  plain_lane_gather(featT, idx_lane))
    print(f"gather probe: the five forms agree; {', '.join(FORMS)} and the "
          f"lane gather bit-exact at feat {tuple(feat.shape)} idx "
          f"({PROBE_N},) and featT {tuple(featT.shape)} idx ({LANE_N},)",
          flush=True)
    results = []
    for form, kernel in FORMS.items():
        common.timed(kernel.name, "probe shape", f"f32 feat "
                      f"{tuple(feat.shape)} idx ({PROBE_N},)",
                      lambda: kernel(feat, idx),
                      lambda: plain_row_gather(feat, idx),
                      gather_work(feat, PROBE_N), 0.0, card_name,
                      (50, 50), lambda: feat.index_select(0, idx))
    results.append(common.timed(
        lane_gather_cuda.name, "probe shape", f"f32 featT "
        f"{tuple(featT.shape)} idx ({LANE_N},)",
        lambda: lane_gather_cuda(featT, idx_lane),
        lambda: plain_lane_gather(featT, idx_lane),
        (featT.numel() * 4 + LANE_N * 8 + LANE_ROWS * LANE_N * 4, 0.0),
        lane_err, card_name, (50, 50),
        lambda: featT.index_select(1, idx_lane)))
    print("gather probe, host time to enqueue one call at the probe's "
          "shapes: " + ", ".join(
              f"{name} {common.host_us(fn)!r} us" for name, fn in (
                  ("lane_gather_cuda",
                   lambda: lane_gather_cuda(featT, idx_lane)),
                  ("featT.index_select", lambda: featT.index_select(
                      1, idx_lane)),
                  ("row_gather_ldg_cuda", lambda: row_gather_ldg_cuda(
                      feat, idx)),
                  ("feat.index_select", lambda: feat.index_select(0, idx))))
          + f" [{card_name}]", flush=True)

    for (l, C, D, h, w), table, qidx, rows in quad_gather_inputs(device,
                                                                 img_wh):
        for form, kernel in FORMS.items():
            common.check_exact(f"{kernel.name} L{l} quad gather",
                               kernel(table, qidx), rows)
        del rows
        N = qidx.shape[0]
        for form, kernel in FORMS.items():
            results.append(common.timed(
                kernel.name, "quad gather B=1",
                f"L{l} bf16 table {tuple(table.shape)} rows ({N}, {4 * C})",
                lambda: kernel(table, qidx),
                lambda: plain_row_gather(table, qidx),
                gather_work(table, N), 0.0, card_name, (20, 5),
                lambda: table.index_select(0, qidx)))
        del table, qidx
    return results


if __name__ == "__main__":
    main()
