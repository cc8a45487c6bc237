"""Camera-file parsing and projection-matrix pipelines.

The port's copy of ``casmvsnet_pl_tpu/data/cams.py``. A ``*_cam.txt``
holds a 4x4 world-to-camera extrinsic (lines 1-4), a 3x3 intrinsic (lines
7-9) and a depth_min on line 11. ``pair.txt`` lists, per reference view,
the scored source views.

Per-level 4x4 projections: the intrinsic is expressed at the *coarsest*
(1/4) resolution and doubled per level, giving ``proj[level] = K_level @ E``
ordered fine -> coarse (index 0 = full resolution). The model consumes
relative projections ``src_proj @ inv(ref_proj)``.
"""
from __future__ import annotations

import numpy as np


def read_cam_file(path: str) -> tuple[np.ndarray, np.ndarray, float]:
    """Parse a cam.txt -> (intrinsics (3,3), extrinsics (4,4), depth_min)."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ")
    extrinsics = extrinsics.reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ")
    intrinsics = intrinsics.reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    return intrinsics, extrinsics, depth_min


def read_pair_file(path: str) -> list[tuple[int, list[int], int]]:
    """Parse pair.txt -> [(ref_view, src_views, n_valid), ...].

    n_valid is the declared number of scored source views (BlendedMVS skips
    references with too few valid sources).
    """
    out = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            ref = int(f.readline().rstrip())
            items = f.readline().rstrip().split()
            n_valid = int(items[0])
            srcs = [int(x) for x in items[1::2]]
            out.append((ref, srcs, n_valid))
    return out


def build_level_proj_mats(intrinsics: np.ndarray, extrinsics: np.ndarray,
                          levels: int = 3) -> np.ndarray:
    """Per-level 4x4 projections, fine -> coarse.

    ``intrinsics`` must already be scaled to the *coarsest* level; it is
    doubled per finer level.
    Returns (levels, 4, 4) float32.
    """
    K = intrinsics.astype(np.float64).copy()
    mats_coarse_to_fine = []
    for _ in range(levels):
        P = np.eye(4, dtype=np.float64)
        P[:3, :4] = K @ extrinsics.astype(np.float64)[:3, :4]
        mats_coarse_to_fine.append(P)
        K[:2] *= 2
    # coarse->fine accumulated; return fine->coarse
    return np.stack(mats_coarse_to_fine[::-1]).astype(np.float32)


def relative_proj_mats(ref_proj: np.ndarray, src_projs: np.ndarray) -> np.ndarray:
    """Compose per-level relative projections src @ inv(ref), keep 3x4 rows.

    ref_proj: (L, 4, 4); src_projs: (V-1, L, 4, 4) -> (V-1, L, 3, 4).
    """
    ref_inv = np.linalg.inv(ref_proj.astype(np.float64))     # (L, 4, 4)
    rel = np.einsum("vlij,ljk->vlik", src_projs.astype(np.float64), ref_inv)
    return rel[:, :, :3].astype(np.float32)


def scale_intrinsics_to_coarsest(intrinsics: np.ndarray, native_wh: tuple[int, int],
                                 img_wh: tuple[int, int]) -> np.ndarray:
    """Rescale intrinsics from native image size to img_wh at 1/4 resolution
    (the coarsest cascade level)."""
    K = intrinsics.copy()
    K[0] *= img_wh[0] / native_wh[0] / 4
    K[1] *= img_wh[1] / native_wh[1] / 4
    return K
