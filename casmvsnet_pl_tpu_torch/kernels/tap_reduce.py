"""Launch the weighted 4-tap reduce of the packed-quad sampler.

Two wrappers, each with its own launch count, over ``csrc/tap_reduce.cu``
in the shared library that ``kernels/cost_volume.py`` builds from
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

from .cost_volume import _CHANNELS, _DTYPE_CODES, _LIBRARY, _Kernel

Tensor = torch.Tensor


def _check_inputs(name: str, rows: Tensor, w: Tensor,
                  g: Tensor | None = None) -> None:
    """Raise on anything the kernels do not take (shapes as in
    :meth:`TapReduceKernel.__call__`)."""
    tensors = (rows, w) + (() if g is None else (g,))
    if not all(t.is_cuda and t.device == rows.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} records no autograd graph; differentiate "
                         "through ops.grid_sample.grid_sample_quad")
    if rows.ndim != 2 or rows.shape[1] % 4:
        raise ValueError(f"rows must be (N, 4C), got {tuple(rows.shape)}")
    N, C = rows.shape[0], rows.shape[1] // 4
    if rows.dtype not in _DTYPE_CODES:
        raise ValueError(f"rows dtype {rows.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if C not in _CHANNELS:
        raise ValueError(f"C={C} not in {_CHANNELS}")
    if w.shape != (N, 4) or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 {(N, 4)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if g is not None and (g.shape != (N, C) or g.dtype != torch.float32):
        raise ValueError(f"g must be f32 {(N, C)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must be 16-byte aligned")


class TapReduceKernel(_Kernel):
    """TPU kernel #7, ``csrc/tap_reduce.cu``."""

    name = "tap_reduce_cuda"

    def __call__(self, rows: Tensor, w: Tensor) -> Tensor:
        """rows (N, 4C) f32|bf16, C in {8, 16, 32}, a sample's four taps
        in ``pack_quad``'s order; w (N, 4) f32 tap weights. Returns (N, C)
        f32, with no autograd graph."""
        _check_inputs(self.name, rows, w)
        N, C = rows.shape[0], rows.shape[1] // 4
        out = torch.empty((N, C), dtype=torch.float32, device=rows.device)
        if N == 0:
            return out
        lib = self.build()
        with torch.cuda.device(rows.device):
            err = lib.tap_reduce_fwd(
                rows.data_ptr(), w.data_ptr(), out.data_ptr(), N, C,
                _DTYPE_CODES[rows.dtype],
                torch.cuda.current_stream().cuda_stream)
        self.library.check(err, self.name)
        self.launches += 1
        return out


class TapReduceBwdKernel(_Kernel):
    """TPU kernel #8, the VJP of :class:`TapReduceKernel`,
    ``csrc/tap_reduce.cu``."""

    name = "tap_reduce_bwd_cuda"

    def __call__(self, rows: Tensor, w: Tensor, g: Tensor
                 ) -> tuple[Tensor, Tensor]:
        """Inputs as :meth:`TapReduceKernel.__call__`, plus g (N, C) f32,
        the gradient of its output. Returns (d rows in the rows' dtype, d w
        (N, 4) f32), each element written once (no atomics: the same result
        from run to run)."""
        _check_inputs(self.name, rows, w, g)
        N, C = rows.shape[0], rows.shape[1] // 4
        d_rows = torch.empty_like(rows)
        d_w = torch.empty_like(w)
        if N == 0:
            return d_rows, d_w
        lib = self.build()
        with torch.cuda.device(rows.device):
            err = lib.tap_reduce_bwd(
                rows.data_ptr(), w.data_ptr(), g.data_ptr(),
                d_rows.data_ptr(), d_w.data_ptr(), N, C,
                _DTYPE_CODES[rows.dtype],
                torch.cuda.current_stream().cuda_stream)
        self.library.check(err, self.name)
        self.launches += 1
        return d_rows, d_w


tap_reduce_cuda = TapReduceKernel(_LIBRARY)
tap_reduce_bwd_cuda = TapReduceBwdKernel(_LIBRARY)
