"""Launch the probe kernels: the card's counterparts of TPU kernels #9-#13.

Eight wrappers, each with its own launch count, over three sources of the
shared library that ``kernels/library.py`` builds from ``csrc/``:

- ``lane_prefix_copy_cuda``, ``csrc/probe_copy_gather.cu``: TPU kernel
  #11, ``scripts/probe_epi3.py::make_copy``;
- ``row_gather_ldg_cuda``, ``row_gather_cp_async_cuda``,
  ``row_gather_bulk_cuda`` (three Hopper forms of the row gather) and
  ``lane_gather_cuda``, ``csrc/probe_copy_gather.cu``: TPU kernel #13,
  ``scripts/probe_gather.py::try_kernel``;
- ``variance_dblk_cuda`` and ``variance_v3_cuda``,
  ``csrc/probe_epilogue.cu``: TPU kernels #9, ``scripts/probe_epi2.py::
  variance_dblk``, and #10, ``scripts/probe_epi3.py::make_var``;
- ``patch_epilogue_t_cuda``, ``csrc/patch_epilogue_t.cu``: TPU kernel #12,
  ``scripts/probe_epi5.py::_pallas_epi``.

Plain versions and the probes that drive them: ``probes/``. The wrappers are
raw launches that record no autograd graph (the TPU probes have no VJP).
There is no fallback: on a CUDA tensor a wrapper launches its kernel or
raises.
"""
from __future__ import annotations

import torch

from .cost_epilogue import check_inputs as check_epilogue
from .library import (DTYPE_CODES, LIBRARY, Kernel, check_device,
                      check_layout)

Tensor = torch.Tensor

COPY_ROWS_PER_BLOCK = (1024, 8192)   # the probe's tiles T
V3_THREADS = (64, 128, 256, 512, 1024)
BULK_MAX_ROW_BYTES = 8192            # the bulk form's shared-memory tile
_GATHER_FORMS = {"ldg": 0, "cp_async": 1, "bulk": 2}


def _check(name: str, *tensors: Tensor) -> int:
    """Raise unless the tensors are on one CUDA device, contiguous, 16-byte
    aligned and outside any autograd graph; returns the device index."""
    dev = check_device(name, tensors, " (the probe kernels have no VJP)")
    check_layout(name, tensors)
    return dev


def _check_dtype(name: str, t: Tensor, what: str) -> None:
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: {what} dtype {t.dtype} not in "
                         f"{list(DTYPE_CODES)}")


def _check_idx(name: str, idx: Tensor) -> None:
    if idx.ndim != 1 or idx.dtype is not torch.int64:
        raise ValueError(f"{name}: idx must be int64 (N,), got {idx.dtype} "
                         f"{tuple(idx.shape)}")


class LanePrefixCopyKernel(Kernel):
    """TPU kernel #11, ``csrc/probe_copy_gather.cu``."""

    def __call__(self, rows: Tensor, rows_per_block: int = 1024) -> Tensor:
        """rows (..., 4C) f32|bf16, C times the element size a multiple of
        16 bytes. Returns rows[..., :C] as a new contiguous tensor;
        ``rows_per_block`` in {1024, 8192} rows per block (the probe's T)."""
        dev = _check(self.name, rows)
        _check_dtype(self.name, rows, "rows")
        if rows.ndim < 1 or rows.shape[-1] % 4:
            raise ValueError(f"{self.name}: rows must be (..., 4C), got "
                             f"{tuple(rows.shape)}")
        C = rows.shape[-1] // 4
        prefix = C * rows.element_size()
        if prefix == 0 or prefix % 16:
            raise ValueError(f"{self.name}: C={C} of {rows.dtype} is not a "
                             "multiple of 16 bytes")
        if rows_per_block not in COPY_ROWS_PER_BLOCK:
            raise ValueError(f"{self.name}: rows_per_block {rows_per_block} "
                             f"not in {COPY_ROWS_PER_BLOCK}")
        out = rows.new_empty(rows.shape[:-1] + (C,))
        n = rows.numel() // rows.shape[-1]
        if n:
            self._launch(dev, rows.data_ptr(), out.data_ptr(), n, prefix,
                         rows_per_block)
        return out


class RowGatherKernel(Kernel):
    """TPU kernel #13's row gather in one of three Hopper forms ("ldg",
    "cp_async", "bulk"), ``csrc/probe_copy_gather.cu``."""

    def __init__(self, library, name: str, form: str):
        super().__init__(library, name, "row_gather_fwd")
        self.form = form

    def __call__(self, table: Tensor, idx: Tensor) -> Tensor:
        """table (n, R) f32|bf16 with rows of a multiple of 16 bytes (at
        most 8192 for the bulk form); idx (N,) int64 in [0, n). Returns
        table[idx] (N, R); an index outside the table is a device fault."""
        dev = _check(self.name, table, idx)
        _check_dtype(self.name, table, "table")
        _check_idx(self.name, idx)
        if table.ndim != 2:
            raise ValueError(f"{self.name}: table must be (n, R), got "
                             f"{tuple(table.shape)}")
        row_bytes = table.shape[1] * table.element_size()
        if row_bytes == 0 or row_bytes % 16:
            raise ValueError(f"{self.name}: rows of {row_bytes} bytes, not a "
                             "multiple of 16")
        if self.form == "bulk" and row_bytes > BULK_MAX_ROW_BYTES:
            raise ValueError(f"{self.name}: rows of {row_bytes} bytes exceed "
                             f"the {BULK_MAX_ROW_BYTES}-byte tile")
        out = table.new_empty((idx.shape[0], table.shape[1]))
        if idx.shape[0]:
            self._launch(dev, table.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), table.shape[0], idx.shape[0],
                         row_bytes, _GATHER_FORMS[self.form])
        return out


class LaneGatherKernel(Kernel):
    """TPU kernel #13's lane gather, ``csrc/probe_copy_gather.cu``."""

    def __call__(self, featT: Tensor, idx: Tensor) -> Tensor:
        """featT (R, L) f32|bf16; idx (J,) int64 in [0, L). Returns
        featT[:, idx] (R, J)."""
        dev = _check(self.name, featT, idx)
        _check_dtype(self.name, featT, "featT")
        _check_idx(self.name, idx)
        if featT.ndim != 2:
            raise ValueError(f"{self.name}: featT must be (R, L), got "
                             f"{tuple(featT.shape)}")
        R, L = featT.shape
        J = idx.shape[0]
        out = featT.new_empty((R, J))
        if R and J:
            self._launch(dev, featT.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), R, L, J, featT.element_size())
        return out


class VarianceDblkKernel(Kernel):
    """TPU kernel #9, ``csrc/probe_epilogue.cu``."""

    def __call__(self, ref: Tensor, rows: Tensor, ws: Tensor,
                 dblk: int) -> Tensor:
        """Inputs as ``kernels/cost_epilogue.py::EpilogueKernel`` (ref (B,
        HW, C), rows (B, S, D, HW, 4C), ws (B, S, D, HW, 4) f32); each
        thread walks ``dblk`` >= 1 consecutive depths. Returns the variance
        (B, D, HW, C) in ref's dtype."""
        dev = _check(self.name, ref, rows, ws)
        check_epilogue(self.name, ref, rows, ws, 1)
        if int(dblk) < 1:
            raise ValueError(f"{self.name}: dblk={dblk} must be >= 1")
        B, hw, C = ref.shape
        S, D = rows.shape[1:3]
        out = ref.new_empty((B, D, hw, C))
        self._launch(dev, ref.data_ptr(), rows.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), B, S, D, hw, C, int(dblk),
                     DTYPE_CODES[ref.dtype])
        return out


class VarianceV3Kernel(Kernel):
    """TPU kernel #10, ``csrc/probe_epilogue.cu``."""

    def __call__(self, ref: Tensor, rows: Tensor, ws: Tensor,
                 threads: int = 128) -> Tensor:
        """As :class:`VarianceDblkKernel` with exactly two source views (V
        = 3) and ``threads`` in {64, 128, 256, 512, 1024} per block (the
        probe's T)."""
        dev = _check(self.name, ref, rows, ws)
        check_epilogue(self.name, ref, rows, ws, 1)
        if rows.shape[1] != 2:
            raise ValueError(f"{self.name} takes S=2 source views, got "
                             f"rows {tuple(rows.shape)}")
        if threads not in V3_THREADS:
            raise ValueError(f"{self.name}: threads={threads} not in "
                             f"{V3_THREADS}")
        B, hw, C = ref.shape
        D = rows.shape[2]
        out = ref.new_empty((B, D, hw, C))
        self._launch(dev, ref.data_ptr(), rows.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), B, D, hw, C, threads,
                     DTYPE_CODES[ref.dtype])
        return out


class PatchEpilogueTKernel(Kernel):
    """TPU kernel #12, ``csrc/patch_epilogue_t.cu``."""

    def __call__(self, rowsT: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
        """rowsT (n_i, 16 Ch, HW) f32|bf16, Ch a multiple of 4: gathered 4x4
        patch rows, pixels last; fx, fy (n_i, g, HW) f32 fractional
        coordinates in the patch, g in {1, 2, 4, 8}. Returns (n_i, g, Ch,
        HW) f32."""
        dev = _check(self.name, rowsT, fx, fy)
        _check_dtype(self.name, rowsT, "rowsT")
        if rowsT.ndim != 3 or rowsT.shape[1] % 64:
            raise ValueError(f"{self.name}: rowsT must be (n_i, 16 Ch, HW) "
                             f"with Ch a multiple of 4, got "
                             f"{tuple(rowsT.shape)}")
        n_i, L, hw = rowsT.shape
        if fx.ndim != 3 or fx.shape[0] != n_i or fx.shape[2] != hw \
                or fx.shape[1] not in (1, 2, 4, 8):
            raise ValueError(f"{self.name}: fx must be (n_i={n_i}, g, "
                             f"HW={hw}) with g in (1, 2, 4, 8), got "
                             f"{tuple(fx.shape)}")
        if fy.shape != fx.shape or fx.dtype != torch.float32 \
                or fy.dtype != torch.float32:
            raise ValueError(f"{self.name}: fx and fy must be f32 "
                             f"{tuple(fx.shape)}, got {fx.dtype} "
                             f"{tuple(fx.shape)} and {fy.dtype} "
                             f"{tuple(fy.shape)}")
        g, Ch = fx.shape[1], L // 16
        out = rowsT.new_empty((n_i, g, Ch, hw), dtype=torch.float32)
        if out.numel():
            self._launch(dev, rowsT.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                         out.data_ptr(), n_i, g, Ch, hw,
                         DTYPE_CODES[rowsT.dtype])
        return out


lane_prefix_copy_cuda = LanePrefixCopyKernel(
    LIBRARY, "lane_prefix_copy_cuda", "lane_prefix_copy_fwd")
row_gather_ldg_cuda = RowGatherKernel(LIBRARY, "row_gather_ldg_cuda", "ldg")
row_gather_cp_async_cuda = RowGatherKernel(LIBRARY,
                                           "row_gather_cp_async_cuda",
                                           "cp_async")
row_gather_bulk_cuda = RowGatherKernel(LIBRARY, "row_gather_bulk_cuda",
                                       "bulk")
lane_gather_cuda = LaneGatherKernel(LIBRARY, "lane_gather_cuda",
                                    "lane_gather_fwd")
variance_dblk_cuda = VarianceDblkKernel(LIBRARY, "variance_dblk_cuda",
                                        "variance_dblk_fwd")
variance_v3_cuda = VarianceV3Kernel(LIBRARY, "variance_v3_cuda",
                                    "variance_v3_fwd")
patch_epilogue_t_cuda = PatchEpilogueTKernel(
    LIBRARY, "patch_epilogue_t_cuda", "patch_epilogue_t_fwd")
