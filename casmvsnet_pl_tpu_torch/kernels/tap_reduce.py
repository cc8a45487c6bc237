"""Launch the weighted 4-tap reduce of the packed-quad sampler.

Two wrappers, each with its own launch count, over ``csrc/tap_reduce.cu``
in the shared library that ``kernels/library.py`` builds from
``csrc/``:

- ``tap_reduce_cuda``: TPU kernel #7,
  ``scripts/kernel_tap_reduce.py::_forward``;
- ``tap_reduce_bwd_cuda``: TPU kernel #8, its VJP, ``_vjp_bwd``.

Plain versions: ``ops/tap_reduce.py``. The wrappers are raw launches that
record no autograd graph; ``ops/grid_sample.py::grid_sample_quad`` joins
them into a ``torch.autograd.Function``. There is no fallback: on a CUDA
tensor a wrapper launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .library import (CHANNELS, DTYPE_CODES, LIBRARY, Kernel, check_device,
                      check_layout)

Tensor = torch.Tensor


def _check_inputs(name: str, rows: Tensor, w: Tensor,
                  g: Tensor | None = None) -> int:
    """Raise on anything the kernels do not take (shapes as in
    :meth:`TapReduceKernel.__call__`); returns the device index."""
    tensors = (rows, w) + (() if g is None else (g,))
    dev = check_device(name, tensors, "; differentiate through "
                       "ops.grid_sample.grid_sample_quad")
    if rows.ndim != 2 or rows.shape[1] % 4:
        raise ValueError(f"rows must be (N, 4C), got {tuple(rows.shape)}")
    N, C = rows.shape[0], rows.shape[1] // 4
    if rows.dtype not in DTYPE_CODES:
        raise ValueError(f"rows dtype {rows.dtype} not in "
                         f"{list(DTYPE_CODES)}")
    if C not in CHANNELS:
        raise ValueError(f"C={C} not in {CHANNELS}")
    if w.shape != (N, 4) or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 {(N, 4)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if g is not None and (g.shape != (N, C) or g.dtype != torch.float32):
        raise ValueError(f"g must be f32 {(N, C)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    check_layout(name, tensors)
    return dev


class TapReduceKernel(Kernel):
    """TPU kernel #7, ``csrc/tap_reduce.cu``."""

    def __call__(self, rows: Tensor, w: Tensor) -> Tensor:
        """rows (N, 4C) f32|bf16, C in {8, 16, 32}, a sample's four taps
        in ``pack_quad``'s order; w (N, 4) f32 tap weights. Returns (N, C)
        f32, with no autograd graph."""
        dev = _check_inputs(self.name, rows, w)
        N, C = rows.shape[0], rows.shape[1] // 4
        out = rows.new_empty((N, C), dtype=torch.float32)
        if N:
            self._launch(dev, rows.data_ptr(), w.data_ptr(), out.data_ptr(),
                         N, C, DTYPE_CODES[rows.dtype])
        return out


class TapReduceBwdKernel(Kernel):
    """TPU kernel #8, the VJP of :class:`TapReduceKernel`,
    ``csrc/tap_reduce.cu``."""

    def __call__(self, rows: Tensor, w: Tensor, g: Tensor
                 ) -> tuple[Tensor, Tensor]:
        """Inputs as :meth:`TapReduceKernel.__call__`, plus g (N, C) f32,
        the gradient of its output. Returns (d rows in the rows' dtype, d w
        (N, 4) f32), each element written once (no atomics: the same result
        from run to run)."""
        dev = _check_inputs(self.name, rows, w, g)
        N, C = rows.shape[0], rows.shape[1] // 4
        d_rows = torch.empty_like(rows)
        d_w = torch.empty_like(w)
        if N:
            self._launch(dev, rows.data_ptr(), w.data_ptr(), g.data_ptr(),
                         d_rows.data_ptr(), d_w.data_ptr(), N, C,
                         DTYPE_CODES[rows.dtype])
        return d_rows, d_w


tap_reduce_cuda = TapReduceKernel(LIBRARY, "tap_reduce_cuda",
                                  "tap_reduce_fwd")
tap_reduce_bwd_cuda = TapReduceBwdKernel(LIBRARY, "tap_reduce_bwd_cuda",
                                         "tap_reduce_bwd")
