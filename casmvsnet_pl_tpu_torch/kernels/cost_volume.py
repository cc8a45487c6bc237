"""Build, bind and launch the fused CUDA cost-volume kernels.

Two kernels, one shared library:

- K1, ``csrc/cost_volume.cu``: the forward. It replaces the TPU package's
  Pallas patch epilogue (``casmvsnet_pl_tpu/kernels/patch_epilogue.py::
  _pallas_fwd_call``) together with the projection, gathers and combine
  that XLA ran around it. Plain version: ``ops/plane_sweep.py::
  plain_cost_volume``.
- K2, ``csrc/cost_volume_bwd.cu``: its adjoint with respect to the
  features. It replaces the Pallas backward (``_pallas_bwd_call``) and the
  cotangent scatter around it. Plain version: ``ops/plane_sweep.py::
  plain_cost_volume_bwd``.

The two wrappers are raw launches and record no autograd graph;
``ops/plane_sweep.py::build_cost_volume`` joins them into a
``torch.autograd.Function``. At first use the sources in ``csrc/`` are
compiled by one ``nvcc`` call for ``sm_90a``, in parallel, into a shared
library in ``_build/`` inside this package, keyed by a hash of the sources
and flags, and loaded with ``ctypes``. There is no fallback: on a CUDA
tensor a wrapper launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# "-t 0": nvcc compiles the sources in parallel, one thread each
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-t", "0")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNELS = (8, 16, 32)
_GROUPS = (1, 2, 4, 8)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                       "cost-volume kernels are compiled from csrc/ at first "
                       "use and have no fallback")


class KernelLibrary:
    """The shared library built from every source in ``csrc/``."""

    def __init__(self):
        self.build_log = ""
        self._lib = None

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the shared library."""
        if self._lib is not None:
            return self._lib
        sources = sorted(p for p in CSRC_DIR.iterdir()
                         if p.suffix in (".cu", ".cuh"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sources:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        lib_path = BUILD_DIR / f"cost_volume_{h.hexdigest()[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(p) for p in sources if p.suffix == ".cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.cost_volume_fwd.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
        lib.cost_volume_fwd.restype = ctypes.c_int
        lib.cost_volume_bwd.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
        lib.cost_volume_bwd.restype = ctypes.c_int
        lib.cost_volume_error_string.argtypes = [ctypes.c_int]
        lib.cost_volume_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def check(self, err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"{name} kernel launch failed: " +
                               self._lib.cost_volume_error_string(err)
                               .decode())


def _check_inputs(name: str, feats: Tensor, proj_mats: Tensor,
                  depth_values: Tensor, groups: int, *extra: Tensor) -> None:
    """Raise on anything the kernels do not take (shapes as in
    :meth:`CostVolumeKernel.__call__`)."""
    tensors = (feats, proj_mats, depth_values, *extra)
    if not all(t.is_cuda and t.device == feats.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} records no autograd graph; differentiate "
                         "through ops.plane_sweep.build_cost_volume")
    if feats.ndim != 5:
        raise ValueError(f"feats must be (B, V, H, W, C), got "
                         f"{tuple(feats.shape)}")
    B, V, H, W, C = feats.shape
    if feats.dtype not in _DTYPE_CODES:
        raise ValueError(f"feats dtype {feats.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if C not in _CHANNELS:
        raise ValueError(f"C={C} not in {_CHANNELS}")
    if groups not in _GROUPS or C % groups:
        raise ValueError(f"groups={groups} not in {_GROUPS} or does not "
                         f"divide C={C}")
    if V < 2:
        raise ValueError("need a reference and at least one source view")
    if proj_mats.shape != (B, V - 1, 3, 4) or proj_mats.dtype != torch.float32:
        raise ValueError(f"proj_mats must be f32 {(B, V - 1, 3, 4)}, got "
                         f"{proj_mats.dtype} {tuple(proj_mats.shape)}")
    if depth_values.ndim != 4 or depth_values.shape[0] != B \
            or depth_values.shape[2:] != (H, W) \
            or depth_values.dtype != torch.float32:
        raise ValueError(f"depth_values must be f32 (B, D, {H}, {W}), got "
                         f"{depth_values.dtype} {tuple(depth_values.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (feats, *extra)):
        raise ValueError(f"{name}: feats and gradients must be 16-byte "
                         "aligned")


class _Kernel:
    """A kernel of the library behind a callable with a launch count.

    ``launches`` goes up by one at each kernel launch and nowhere else, so
    a caller can reset it and show that a run went through the kernel.
    """

    def __init__(self, library: KernelLibrary):
        self.library = library
        self.launches = 0

    def build(self) -> ctypes.CDLL:
        return self.library.build()

    @property
    def build_log(self) -> str:
        return self.library.build_log


class CostVolumeKernel(_Kernel):
    """K1, the fused cost-volume forward."""

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, groups: int = 1) -> Tensor:
        """feats (B, V, H, W, C) f32|bf16, C in {8, 16, 32};
        proj_mats (B, V-1, 3, 4) f32; depth_values (B, D, H, W) f32;
        groups 1 (variance) or G in {2, 4, 8} (groupwise).
        Returns (B, D, H, W, C|G) in the feats dtype, with no autograd
        graph."""
        _check_inputs("cost_volume_cuda", feats, proj_mats, depth_values,
                      groups)
        B, V, H, W, C = feats.shape
        D = depth_values.shape[1]
        out = torch.empty((B, D, H, W, C if groups == 1 else groups),
                          dtype=feats.dtype, device=feats.device)
        lib = self.build()
        with torch.cuda.device(feats.device):
            err = lib.cost_volume_fwd(
                feats.data_ptr(), proj_mats.data_ptr(),
                depth_values.data_ptr(), out.data_ptr(), B, V, H, W, D, C,
                groups, _DTYPE_CODES[feats.dtype],
                torch.cuda.current_stream().cuda_stream)
        self.library.check(err, "cost_volume")
        self.launches += 1
        return out


class CostVolumeBwdKernel(_Kernel):
    """K2, the adjoint of K1 with respect to the features, with its own
    launch count."""

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, grad_out: Tensor,
                 groups: int = 1) -> Tensor:
        """Inputs as :meth:`CostVolumeKernel.__call__`, plus grad_out, the
        gradient of its output: (B, D, H, W, C|G) in the feats dtype.
        Returns d feats (B, V, H, W, C) in the feats dtype, accumulated in
        float32 and cast once."""
        _check_inputs("cost_volume_bwd_cuda", feats, proj_mats, depth_values,
                      groups, grad_out)
        B, V, H, W, C = feats.shape
        D = depth_values.shape[1]
        want = (B, D, H, W, C if groups == 1 else groups)
        if tuple(grad_out.shape) != want or grad_out.dtype != feats.dtype:
            raise ValueError(f"grad_out must be {feats.dtype} {want}, got "
                             f"{grad_out.dtype} {tuple(grad_out.shape)}")
        grad = torch.zeros(feats.shape, dtype=torch.float32,
                           device=feats.device)
        lib = self.build()
        with torch.cuda.device(feats.device):
            err = lib.cost_volume_bwd(
                feats.data_ptr(), proj_mats.data_ptr(),
                depth_values.data_ptr(), grad_out.data_ptr(),
                grad.data_ptr(), B, V, H, W, D, C, groups,
                _DTYPE_CODES[feats.dtype],
                torch.cuda.current_stream().cuda_stream)
        self.library.check(err, "cost_volume_bwd")
        self.launches += 1
        return grad.to(feats.dtype)


_LIBRARY = KernelLibrary()
cost_volume_cuda = CostVolumeKernel(_LIBRARY)
cost_volume_bwd_cuda = CostVolumeBwdKernel(_LIBRARY)
