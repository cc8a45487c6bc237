"""Build, bind and launch the fused CUDA cost-volume kernels.

One shared library holds every kernel of ``csrc/``: the two here, the
quad configuration's cost epilogues, launched from
``kernels/cost_epilogue.py``, the weighted 4-tap reduce of the
packed-quad sampler, launched from ``kernels/tap_reduce.py``, CostRegNet's
8 -> 1 ``prob`` convolution (``csrc/prob_conv.cu``, which replaces no TPU
kernel), launched from ``kernels/prob_conv.py``, and the probes of TPU
kernels #9-#13, launched from ``kernels/probes.py``.

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
and flags, and loaded with ``ctypes``. Every wrapper of the package
launches through :meth:`_Kernel._launch`: its C function bound once and
called with one argument, every value packed into an int64 array; the
device made current only when it is not; the raw current stream. So a
launch costs the host about what a PyTorch operator does. There is no
fallback: on a CUDA tensor a wrapper launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
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
        lib.cost_volume_error_string.argtypes = [ctypes.c_int]
        lib.cost_volume_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def check(self, err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"{name} kernel launch failed: " +
                               self._lib.cost_volume_error_string(err)
                               .decode())


# torch._C's current device and raw current stream, bound at the first launch
# (the CPU build of torch has neither)
_get_device = _raw_stream = None


def check_device(name: str, tensors, hint: str) -> int:
    """The CUDA device index of ``tensors``; raise unless they all lie on
    that one CUDA device and none records an autograd graph (``hint`` ends
    the message)."""
    dev = tensors[0].get_device()
    grad = torch.is_grad_enabled()
    for t in tensors:
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if grad and t.requires_grad:
            raise ValueError(f"{name} records no autograd graph{hint}")
    return dev


def check_layout(name: str, tensors, aligned=None,
                 what: str = "every tensor") -> None:
    """Raise unless ``tensors`` are contiguous and ``aligned`` (default: all
    of them) start on a 16-byte boundary."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    for t in tensors if aligned is None else aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


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
            or depth_values.shape[2] != H or depth_values.shape[3] != W \
            or depth_values.dtype != torch.float32:
        raise ValueError(f"depth_values must be f32 (B, D, {H}, {W}), got "
                         f"{depth_values.dtype} {tuple(depth_values.shape)}")
    check_layout(name, tensors, (feats, *extra), "feats and gradients")
    return dev


class _Kernel:
    """A kernel of the library behind a callable with a launch count.

    ``launches`` goes up by one at each kernel launch and nowhere else, so
    a caller can reset it and show that a run went through the kernel.
    Every wrapper launches through :meth:`_launch`.
    """

    def __init__(self, library: KernelLibrary, name: str, entry: str):
        self.library = library
        self.name = name
        self.entry = entry      # the library's C function
        self.launches = 0
        self._fn = self._pack = None

    def build(self) -> ctypes.CDLL:
        return self.library.build()

    @property
    def build_log(self) -> str:
        return self.library.build_log

    def _launch(self, device: int, *args: int) -> None:
        """Call the C entry with ``args`` (pointers as ints) and the current
        stream of CUDA device ``device``, made the current device for the
        call; raise if the launch failed, else count it."""
        global _get_device, _raw_stream
        if self._fn is None:   # int entry(const int64_t* args): every
            # argument packed as int64 (csrc/sampling.cuh::call_packed)
            fn = getattr(self.build(), self.entry)
            fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
            self._fn = fn
            self._pack = struct.Struct(f"={len(args) + 1}q").pack
            _get_device = torch._C._cuda_getDevice
            _raw_stream = torch._C._cuda_getCurrentRawStream
        if _get_device() == device:
            err = self._fn(self._pack(*args, _raw_stream(device)))
        else:
            with torch.cuda.device(device):
                err = self._fn(self._pack(*args, _raw_stream(device)))
        if err:
            self.library.check(err, self.name)
        self.launches += 1


class CostVolumeKernel(_Kernel):
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
                     groups, KINDS[kind], _DTYPE_CODES[feats.dtype])
        return out


class CostVolumeBwdKernel(_Kernel):
    """K2, the adjoint of K1 with respect to the features, with its own
    launch count."""

    def __call__(self, feats: Tensor, proj_mats: Tensor,
                 depth_values: Tensor, grad_out: Tensor,
                 groups: int = 1, kind: str | None = None) -> Tensor:
        """Inputs as :meth:`CostVolumeKernel.__call__`, plus grad_out, the
        gradient of its output: (B, D, H, W, C|G) in the feats dtype.
        Returns d feats (B, V, H, W, C) in the feats dtype, accumulated in
        float32 and cast once. The groupwise correlation with one group
        (TransMVSNet's volume) has no adjoint here yet: TransMVSNet's
        training is a later change."""
        if volume_kind(kind, groups) == "groupwise" and groups == 1:
            raise NotImplementedError(
                f"{self.name}: no backward of the one-group correlation "
                "(TransMVSNet training, with its focal loss and the "
                "deformable conv's backward, is not ported yet)")
        dev = _check_inputs(self.name, feats, proj_mats, depth_values, groups,
                            grad_out)
        B, V, H, W, C = feats.shape
        D = depth_values.shape[1]
        want = (B, D, H, W, C if groups == 1 else groups)
        if grad_out.shape != want or grad_out.dtype != feats.dtype:
            raise ValueError(f"grad_out must be {feats.dtype} {want}, got "
                             f"{grad_out.dtype} {tuple(grad_out.shape)}")
        grad = feats.new_zeros(feats.shape, dtype=torch.float32)
        self._launch(dev, feats.data_ptr(), proj_mats.data_ptr(),
                     depth_values.data_ptr(), grad_out.data_ptr(),
                     grad.data_ptr(), B, V, H, W, D, C, groups,
                     _DTYPE_CODES[feats.dtype])
        return grad.to(feats.dtype)


_LIBRARY = KernelLibrary()
cost_volume_cuda = CostVolumeKernel(_LIBRARY, "cost_volume_cuda",
                                    "cost_volume_fwd")
cost_volume_bwd_cuda = CostVolumeBwdKernel(_LIBRARY, "cost_volume_bwd_cuda",
                                           "cost_volume_bwd")
