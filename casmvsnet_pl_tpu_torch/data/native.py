"""Build and bind the data readers' host loops: ``image_native.c`` (and
the CRC-32C of the TensorBoard event writer) and ``jpeg_native.c`` (the
JPEG codec, bound in ``jpeg.py``).

Each is compiled with the host C compiler at first use into ``_build/``
inside the package (once per source hash) and loaded with ``ctypes``.
There is no fallback: if the build fails, the caller gets the compiler's
error.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SOURCE_DIR = Path(__file__).resolve().parent
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def build_library(stem: str) -> ctypes.CDLL:
    """Compile ``<stem>.c`` of this directory (once per source hash) and
    load it. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    source = _SOURCE_DIR / f"{stem}.c"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"{stem}_{digest}.so"
    if not so_path.exists():
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler (cc, gcc) on PATH: the host "
                               f"loops are built from {source}")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, "-O3", "-shared", "-fPIC", str(source), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, so_path)
    return ctypes.CDLL(str(so_path))


@functools.cache
def image_lib() -> ctypes.CDLL:
    """The compiled ``image_native.c``: ``png_unfilter``, ``resample_u8``
    and ``crc32c``, with their argument types declared."""
    lib = build_library("image_native")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    n = ctypes.c_int64
    lib.png_unfilter.argtypes = [u8, u8, n, n, n]
    lib.png_unfilter.restype = ctypes.c_int
    lib.resample_u8.argtypes = [u8, u8, n, n, n, n, i64, i64, i32, n]
    lib.resample_u8.restype = None
    lib.crc32c.argtypes = [ctypes.c_char_p, n]
    lib.crc32c.restype = ctypes.c_uint32
    return lib
