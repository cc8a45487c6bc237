"""K1 and K2, the fused CUDA cost-volume kernels.

- K1, ``csrc/cost_volume.cu``: the forward. It replaces the TPU package's
  Pallas patch epilogue (``casmvsnet_pl_tpu/kernels/patch_epilogue.py::
  _pallas_fwd_call``) together with the projection, gathers and combine
  that XLA ran around it. Plain version: ``ops/plane_sweep.py::
  plain_cost_volume``.
- K2, ``csrc/cost_volume_bwd.cu``: its adjoint with respect to the
  features. It replaces the Pallas backward (``_pallas_bwd_call``) and the
  cotangent scatter around it. Plain version: ``ops/plane_sweep.py::
  plain_cost_volume_bwd``.

The two wrappers are raw launches of the shared library
(``kernels/library.py``) and record no autograd graph;
``ops/plane_sweep.py::build_cost_volume`` joins them into a
``torch.autograd.Function``. There is no fallback: on a CUDA tensor a
wrapper launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .library import (CHANNELS, DTYPE_CODES, GROUPS, LIBRARY, Kernel,
                      check_device, check_layout)

Tensor = torch.Tensor

# the combine of K1 by kind of volume: the variance (one group) or the
# groupwise correlation (G groups, one included)
KINDS = {"variance": 0, "groupwise": 1}


def volume_kind(kind: str | None, groups: int) -> str:
    """``kind``, or where it is None the kind that ``groups`` alone used to
    name: the variance at G = 1, the groupwise correlation above. Raise on
    a kind the kernels do not know or a variance of several groups."""
    if kind is None:
        return "variance" if groups == 1 else "groupwise"
    if kind not in KINDS:
        raise ValueError(f"unknown cost-volume kind {kind!r} (not in "
                         f"{list(KINDS)})")
    if kind == "variance" and groups != 1:
        raise ValueError(f"a variance volume has one group, got {groups}")
    return kind


def _check_inputs(name: str, feats: Tensor, proj_mats: Tensor,
                  depth_values: Tensor, groups: int, *extra: Tensor) -> int:
    """Raise on anything the kernels do not take (shapes as in
    :meth:`CostVolumeKernel.__call__`); returns the device index."""
    tensors = (feats, proj_mats, depth_values, *extra)
    dev = check_device(name, tensors, "; differentiate through "
                       "ops.plane_sweep.build_cost_volume")
    if feats.ndim != 5:
        raise ValueError(f"feats must be (B, V, H, W, C), got "
                         f"{tuple(feats.shape)}")
    B, V, H, W, C = feats.shape
    if feats.dtype not in DTYPE_CODES:
        raise ValueError(f"feats dtype {feats.dtype} not in "
                         f"{list(DTYPE_CODES)}")
    if C not in CHANNELS:
        raise ValueError(f"C={C} not in {CHANNELS}")
    if groups not in GROUPS or C % groups:
        raise ValueError(f"groups={groups} not in {GROUPS} or does not "
                         f"divide C={C}")
    if V < 2:
        raise ValueError("need a reference and at least one source view")
    if proj_mats.shape != (B, V - 1, 3, 4) or proj_mats.dtype != torch.float32:
        raise ValueError(f"proj_mats must be f32 {(B, V - 1, 3, 4)}, got "
                         f"{proj_mats.dtype} {tuple(proj_mats.shape)}")
    if depth_values.ndim != 4 or depth_values.shape[0] != B \
            or depth_values.shape[2] != H or depth_values.shape[3] != W \
            or depth_values.dtype != torch.float32:
        raise ValueError(f"depth_values must be f32 (B, D, {H}, {W}), got "
                         f"{depth_values.dtype} {tuple(depth_values.shape)}")
    check_layout(name, tensors, (feats, *extra), "feats and gradients")
    return dev


class CostVolumeKernel(Kernel):
    """K1, the fused cost-volume forward."""

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, groups: int = 1,
                 kind: str | None = None) -> Tensor:
        """feats (B, V, H, W, C) f32|bf16, C in {8, 16, 32};
        proj_mats (B, V-1, 3, 4) f32; depth_values (B, D, H, W) f32;
        ``kind`` "variance" (groups 1) or "groupwise" (G in {1, 2, 4, 8});
        None: the variance at groups 1, else the groupwise correlation.
        Returns (B, D, H, W, C) for a variance, (B, D, H, W, G) for a
        groupwise correlation, in the feats dtype, with no autograd
        graph."""
        kind = volume_kind(kind, groups)
        dev = _check_inputs(self.name, feats, proj_mats, depth_values, groups)
        B, V, H, W, C = feats.shape
        D = depth_values.shape[1]
        out = feats.new_empty((B, D, H, W,
                               C if kind == "variance" else groups))
        self._launch(dev, feats.data_ptr(), proj_mats.data_ptr(),
                     depth_values.data_ptr(), out.data_ptr(), B, V, H, W, D, C,
                     groups, KINDS[kind], DTYPE_CODES[feats.dtype])
        return out


class CostVolumeBwdKernel(Kernel):
    """K2, the adjoint of K1 with respect to the features, with its own
    launch count."""

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, grad_out: Tensor,
                 groups: int = 1, kind: str | None = None) -> Tensor:
        """Inputs as :meth:`CostVolumeKernel.__call__`, plus grad_out, the
        gradient of its output: (B, D, H, W, C|G) in the feats dtype.
        Returns d feats (B, V, H, W, C) in the feats dtype, accumulated in
        float32 and cast once; for every kind of K1, the groupwise
        correlation with one group (TransMVSNet's volume) included."""
        kind = volume_kind(kind, groups)
        dev = _check_inputs(self.name, feats, proj_mats, depth_values, groups,
                            grad_out)
        B, V, H, W, C = feats.shape
        D = depth_values.shape[1]
        want = (B, D, H, W, C if kind == "variance" else groups)
        if grad_out.shape != want or grad_out.dtype != feats.dtype:
            raise ValueError(f"grad_out must be {feats.dtype} {want}, got "
                             f"{grad_out.dtype} {tuple(grad_out.shape)}")
        grad = feats.new_zeros(feats.shape, dtype=torch.float32)
        self._launch(dev, feats.data_ptr(), proj_mats.data_ptr(),
                     depth_values.data_ptr(), grad_out.data_ptr(),
                     grad.data_ptr(), B, V, H, W, D, C, groups, KINDS[kind],
                     DTYPE_CODES[feats.dtype])
        return grad.to(feats.dtype)


cost_volume_cuda = CostVolumeKernel(LIBRARY, "cost_volume_cuda",
                                    "cost_volume_fwd")
cost_volume_bwd_cuda = CostVolumeBwdKernel(LIBRARY, "cost_volume_bwd_cuda",
                                           "cost_volume_bwd")
