"""Portable Float Map (PFM) I/O.

The port's copy of ``casmvsnet_pl_tpu/data/pfm.py``: the same bytes on disk.
'PF'/'Pf' header, width height, a scale line whose sign encodes the
endianness, rows stored bottom-up.
"""
from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (data, scale). data is (H, W) or (H, W, 3) float32,
    top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dim_line = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dim_line!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        count = width * height * (3 if color else 1)
        data = np.fromfile(f, endian + "f", count)
        if data.size != count:
            raise ValueError(f"{path}: truncated PFM payload")

    shape = (height, width, 3) if color else (height, width)
    data = np.flipud(data.reshape(shape)).astype(np.float32)
    return np.ascontiguousarray(data), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write (H, W[, 3]) float32 array as PFM (native little-endian)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be (H, W), (H, W, 1) or (H, W, 3)")

    little = (image.dtype.byteorder == "<" or
              (image.dtype.byteorder in ("=", "|") and sys.byteorder == "little"))
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale:f}\n".encode())
        np.flipud(image).tofile(f)
