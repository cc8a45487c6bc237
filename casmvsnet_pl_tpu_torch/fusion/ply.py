"""Binary PLY point-cloud I/O.

The port's copy of ``casmvsnet_pl_tpu/fusion/ply.py``: binary_little_endian
1.0, per-vertex float x/y/z + uchar red/green/blue, the layout the DTU
MATLAB evaluation and standard viewers accept. A file written by either
package reads the same in the other.
"""
from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz: (N, 3) float; rgb: (N, 3) uint8."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    assert xyz.shape == rgb.shape and xyz.shape[1] == 3
    n = xyz.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    vertex = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    vertex["x"], vertex["y"], vertex["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    vertex["red"], vertex["green"], vertex["blue"] = (rgb[:, 0], rgb[:, 1],
                                                      rgb[:, 2])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        vertex.tofile(f)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a binary PLY written by :func:`write_ply` (or compatible).

    Returns (xyz (N, 3) float32, rgb (N, 3) uint8). Only the x/y/z/red/green/
    blue little-endian layout is supported.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = f.readline().strip()
        if b"binary_little_endian" not in fmt:
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        n = None
        props = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            line = line.strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                props.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        if n is None:
            raise ValueError(f"{path}: no vertex element")
        if props[:6] != ["x", "y", "z", "red", "green", "blue"]:
            raise ValueError(f"{path}: unsupported property layout {props}")
        vertex = np.fromfile(
            f, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")], count=n)
    xyz = np.stack([vertex["x"], vertex["y"], vertex["z"]], -1)
    rgb = np.stack([vertex["red"], vertex["green"], vertex["blue"]], -1)
    return xyz, rgb
