"""Build, bind and launch the fused CUDA cost-volume kernel.

The kernel (``csrc/cost_volume.cu``) replaces the TPU package's Pallas
patch epilogue (``casmvsnet_pl_tpu/kernels/patch_epilogue.py::
_pallas_fwd_call``) together with the projection, gathers and combine that
XLA ran around it. Its plain PyTorch version is
``ops/plane_sweep.py::plain_cost_volume``.

At first use the sources in ``csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into ``_build/`` inside this package, keyed by a hash of the
sources and flags, and loaded with ``ctypes``. There is no fallback: on a
CUDA tensor the wrapper launches the kernel or raises.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
                       "cost-volume kernel is compiled from csrc/ at first "
                       "use and has no fallback")


class CostVolumeKernel:
    """The fused cost-volume kernel behind a callable with a launch count.

    ``launches`` goes up by one at each kernel launch and nowhere else, so
    a caller can reset it and show that a run went through the kernel.
    """

    def __init__(self):
        self.launches = 0
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
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(p) for p in sources if p.suffix == ".cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{self.build_log}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.cost_volume_fwd.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
        lib.cost_volume_fwd.restype = ctypes.c_int
        lib.cost_volume_error_string.argtypes = [ctypes.c_int]
        lib.cost_volume_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, groups: int = 1) -> Tensor:
        """feats (B, V, H, W, C) f32|bf16, C in {8, 16, 32};
        proj_mats (B, V-1, 3, 4) f32; depth_values (B, D, H, W) f32;
        groups 1 (variance) or G in {2, 4, 8} (groupwise).
        Returns (B, D, H, W, C|G) in the feats dtype."""
        tensors = (feats, proj_mats, depth_values)
        if not all(t.is_cuda and t.device == feats.device for t in tensors):
            raise ValueError("cost_volume_cuda takes CUDA tensors on one "
                             "device")
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "the CUDA cost-volume kernel has no backward yet; it comes "
                "with the training slice of the port (ROADMAP.md Queue 1 "
                "item 10, kernel K2)")
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
        if proj_mats.shape != (B, V - 1, 3, 4) \
                or proj_mats.dtype != torch.float32:
            raise ValueError(f"proj_mats must be f32 {(B, V - 1, 3, 4)}, got "
                             f"{proj_mats.dtype} {tuple(proj_mats.shape)}")
        if depth_values.ndim != 4 or depth_values.shape[0] != B \
                or depth_values.shape[2:] != (H, W) \
                or depth_values.dtype != torch.float32:
            raise ValueError(f"depth_values must be f32 (B, D, {H}, {W}), got "
                             f"{depth_values.dtype} "
                             f"{tuple(depth_values.shape)}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("cost_volume_cuda takes contiguous tensors")
        if feats.data_ptr() % 16:
            raise ValueError("feats must be 16-byte aligned")
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
        if err:
            raise RuntimeError("cost_volume kernel launch failed: "
                               + lib.cost_volume_error_string(err).decode())
        self.launches += 1
        return out


cost_volume_cuda = CostVolumeKernel()
