"""The shared library of the port's CUDA kernels: how a kernel is built,
bound, checked, launched and counted.

One shared library holds every kernel of ``csrc/``. At first use the
sources are compiled by one ``nvcc`` call for ``sm_90a``, in parallel, into
``_build/cost_volume_<hash>.so`` inside this package, keyed by a hash of the
sources and flags, and loaded with ``ctypes``. Each wrapper of ``kernels/``
is a :class:`Kernel` of :data:`LIBRARY` and launches through
:meth:`Kernel._launch`: its C function bound once and called with one
argument, every value packed into an int64 array, the stream last; the
device made current only when it is not; the raw current stream. So a
launch costs the host about what a PyTorch operator does. There is no
fallback: on a CUDA tensor a wrapper launches its kernel or raises.

A kernel registers by name with its library when it is constructed, and
counts its launches. ``kernels.launch_counts()`` and
``kernels.reset_launches()`` read and reset every kernel of
:data:`LIBRARY`; a kernel of another library (``probes/k1.py``'s K1 of an
earlier tree) stays out of them.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# "-t 0": nvcc compiles the sources in parallel, one thread each
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-t", "0")

# the dtype argument of every C entry
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the channels and groups the cost-volume kernels (K1, K2, #3-#8) are
# instantiated for
CHANNELS = (8, 16, 32)
GROUPS = (1, 2, 4, 8)


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
    """The shared library built from every source in ``csrc/``, and the
    kernels bound to it by name."""

    def __init__(self):
        self.build_log = ""
        self._lib = None
        self.kernels: dict[str, Kernel] = {}

    def register(self, kernel: Kernel) -> None:
        if kernel.name in self.kernels:
            raise ValueError(f"a kernel named {kernel.name!r} is already "
                             "bound to this library")
        self.kernels[kernel.name] = kernel

    def launch_counts(self) -> dict[str, int]:
        """Each kernel's launches by name."""
        return {name: k.launches for name, k in self.kernels.items()}

    def reset_launches(self) -> None:
        for kernel in self.kernels.values():
            kernel.launches = 0

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


class Kernel:
    """A kernel of the library behind a callable with a launch count.

    Construction registers it with ``library`` by ``name`` and builds
    nothing. ``launches`` goes up by one at each kernel launch and nowhere
    else, so a caller can reset it and show that a run went through the
    kernel. Every wrapper launches through :meth:`_launch`.
    """

    def __init__(self, library: KernelLibrary, name: str, entry: str):
        self.library = library
        self.name = name
        self.entry = entry      # the library's C function
        self.launches = 0
        self._fn = self._pack = None
        library.register(self)

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


# the port's library: every wrapper of kernels/ is one of its kernels
LIBRARY = KernelLibrary()
