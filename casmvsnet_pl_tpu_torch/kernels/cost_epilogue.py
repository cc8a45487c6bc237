"""Launch the quad configuration's CUDA cost epilogues.

Four wrappers, each with its own launch count, over two kernels of the
shared library that ``kernels/library.py`` builds from ``csrc/``:

- ``variance_epilogue_cuda`` and ``groupwise_epilogue_cuda``,
  ``csrc/cost_epilogue.cu``: TPU kernels #3 and #5,
  ``scripts/kernel_cost_epilogue.py::variance_epilogue`` and
  ``groupwise_epilogue``;
- ``variance_epilogue_bwd_cuda`` and ``groupwise_epilogue_bwd_cuda``,
  ``csrc/cost_epilogue_bwd.cu``: TPU kernels #4 and #6, ``_var_vjp_bwd``
  and ``_gw_vjp_bwd``.

Plain versions: ``ops/cost_epilogue.py``. The wrappers are raw launches
that record no autograd graph; ``ops/plane_sweep.py::quad_cost_volume``
joins them into a ``torch.autograd.Function``. There is no fallback: on a
CUDA tensor a wrapper launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .library import (CHANNELS, DTYPE_CODES, GROUPS, LIBRARY, Kernel,
                      check_device, check_layout)

Tensor = torch.Tensor


def check_inputs(name: str, ref: Tensor, rows: Tensor, ws: Tensor,
                 groups: int, grad: Tensor | None = None) -> int:
    """Raise on anything the kernels do not take (shapes as in
    :meth:`EpilogueKernel.__call__`); returns the device index."""
    tensors = (ref, rows, ws) + (() if grad is None else (grad,))
    dev = check_device(name, tensors, "; differentiate through "
                       "ops.plane_sweep.quad_cost_volume")
    if ref.ndim != 3:
        raise ValueError(f"ref must be (B, HW, C), got {tuple(ref.shape)}")
    B, hw, C = ref.shape
    if ref.dtype not in DTYPE_CODES:
        raise ValueError(f"ref dtype {ref.dtype} not in {list(DTYPE_CODES)}")
    if C not in CHANNELS:
        raise ValueError(f"C={C} not in {CHANNELS}")
    if groups not in GROUPS or C % groups:
        raise ValueError(f"groups={groups} not in {GROUPS} or does not "
                         f"divide C={C}")
    if rows.ndim != 5 or rows.shape[0] != B or rows.shape[1] < 1 \
            or rows.shape[3:] != (hw, 4 * C) or rows.dtype != ref.dtype:
        raise ValueError(f"rows must be {ref.dtype} (B, S, D, {hw}, {4 * C}) "
                         f"with S >= 1, got {rows.dtype} {tuple(rows.shape)}")
    S, D = rows.shape[1:3]
    if ws.shape != (B, S, D, hw, 4) or ws.dtype != torch.float32:
        raise ValueError(f"ws must be f32 {(B, S, D, hw, 4)}, got "
                         f"{ws.dtype} {tuple(ws.shape)}")
    if grad is not None:
        want = (B, D, hw, C if groups == 1 else groups)
        if tuple(grad.shape) != want or grad.dtype != ref.dtype:
            raise ValueError(f"grad must be {ref.dtype} {want}, got "
                             f"{grad.dtype} {tuple(grad.shape)}")
    check_layout(name, tensors)
    return dev


class _Epilogue(Kernel):
    """A cost epilogue kernel: the variance one (groups == 1 only) or the
    groupwise one (groups > 1 only)."""

    def __init__(self, library, name: str, entry: str, groupwise: bool):
        super().__init__(library, name, entry)
        self.groupwise = groupwise

    def _check_groups(self, groups: int) -> None:
        if (groups != 1) != self.groupwise:
            raise ValueError(f"{self.name} takes groups "
                             f"{'> 1' if self.groupwise else '1'}, got "
                             f"{groups}")


class EpilogueKernel(_Epilogue):
    """TPU kernel #3 (variance) or #5 (groupwise), ``csrc/cost_epilogue.cu``."""

    def __call__(self, ref: Tensor, rows: Tensor, ws: Tensor,
                 groups: int = 1) -> Tensor:
        """ref (B, HW, C) f32|bf16, C in {8, 16, 32}; rows (B, S, D, HW,
        4C) gathered quad rows of the S source views, in ref's dtype; ws
        (B, S, D, HW, 4) f32 tap weights. Returns (B, D, HW, C) (variance)
        or (B, D, HW, G) in ref's dtype, with no autograd graph."""
        self._check_groups(groups)
        dev = check_inputs(self.name, ref, rows, ws, groups)
        B, hw, C = ref.shape
        S, D = rows.shape[1:3]
        out = ref.new_empty((B, D, hw, C if groups == 1 else groups))
        self._launch(dev, ref.data_ptr(), rows.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), B, S, D, hw, C, groups,
                     DTYPE_CODES[ref.dtype])
        return out


class EpilogueBwdKernel(_Epilogue):
    """TPU kernel #4 (variance) or #6 (groupwise), the VJP of
    :class:`EpilogueKernel`, ``csrc/cost_epilogue_bwd.cu``."""

    def __call__(self, ref: Tensor, rows: Tensor, ws: Tensor, grad: Tensor,
                 groups: int = 1) -> tuple[Tensor, Tensor, Tensor]:
        """Inputs as :meth:`EpilogueKernel.__call__`, plus grad, the
        gradient of its output in ref's dtype. Returns (d ref (B, HW, C)
        f32, d rows in the rows' dtype, d ws f32), each element written
        once (no atomics: the same result from run to run)."""
        self._check_groups(groups)
        dev = check_inputs(self.name, ref, rows, ws, groups, grad)
        B, hw, C = ref.shape
        S, D = rows.shape[1:3]
        d_ref = ref.new_empty(ref.shape, dtype=torch.float32)
        d_rows = torch.empty_like(rows)
        d_ws = torch.empty_like(ws)
        self._launch(dev, ref.data_ptr(), rows.data_ptr(), ws.data_ptr(),
                     grad.data_ptr(), d_ref.data_ptr(), d_rows.data_ptr(),
                     d_ws.data_ptr(), B, S, D, hw, C, groups,
                     DTYPE_CODES[ref.dtype])
        return d_ref, d_rows, d_ws


variance_epilogue_cuda = EpilogueKernel(
    LIBRARY, "variance_epilogue_cuda", "cost_epilogue_fwd", groupwise=False)
groupwise_epilogue_cuda = EpilogueKernel(
    LIBRARY, "groupwise_epilogue_cuda", "cost_epilogue_fwd", groupwise=True)
variance_epilogue_bwd_cuda = EpilogueBwdKernel(
    LIBRARY, "variance_epilogue_bwd_cuda", "cost_epilogue_bwd",
    groupwise=False)
groupwise_epilogue_bwd_cuda = EpilogueBwdKernel(
    LIBRARY, "groupwise_epilogue_bwd_cuda", "cost_epilogue_bwd",
    groupwise=True)
