"""Depth filtering and fusion into coloured point clouds.

The port's counterpart of ``casmvsnet_pl_tpu/fusion/fuse.py``, with the
per-view work in torch on one device (the card unless the caller passes
the CPU) and the refinement cache on the host:
  - confidence mask: the quarter-resolution probability upsampled to full
    resolution (OpenCV ``INTER_LINEAR`` semantics) > conf;
  - geometric mask: >= min_geo_consistent source views pass the round-trip
    consistency check (``consistency.py``);
  - iterative refinement: a reference view's fused depth and colour are
    the mean over its consistent sources and itself, and refined views
    are reused as source data for later reference views;
  - accepted pixels are back-projected to world space with the inverse
    level-0 projection, subsampled by ``skip`` and appended to the scan's
    point cloud (binary PLY).

The per-view IO is injected through callables, so any dataset (or a
synthetic scene) can share this loop.
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..data.base import resize_linear
from .consistency import check_geo_consistency
from .ply import write_ply
from .spill import SpillCache

Tensor = torch.Tensor


def upsample_proba(proba: Tensor, img_wh: tuple[int, int]) -> Tensor:
    """Bilinear upsampling of the quarter-resolution confidence (H/4, W/4)
    float32 to ``img_wh`` (w, h), on its device."""
    return resize_linear(proba, img_wh)


def backproject(depth: Tensor, mask: Tensor, colors: Tensor,
                P_world2ref: np.ndarray, skip: int = 1):
    """Masked pixels -> world points. depth (H, W), mask (H, W) bool,
    colors (H, W, 3) float 0-255, on one device.

    Returns (xyz (N, 3) float32, rgb (N, 3) uint8) numpy arrays.
    """
    W = depth.shape[1]
    P_inv = torch.from_numpy(np.linalg.inv(
        np.asarray(P_world2ref, np.float64))[:3]).to(depth.device)
    idx = mask.reshape(-1).nonzero()[:, 0][::skip]
    ys, xs = idx // W, idx % W
    d = depth.reshape(-1)[idx].double()
    h = torch.stack([xs * d, ys * d, d, torch.ones_like(d)])    # (4, N)
    xyz = (P_inv @ h).T.float()
    rgb = colors.reshape(-1, 3)[idx].clamp(0, 255).to(torch.uint8)
    return xyz.cpu().numpy(), rgb.cpu().numpy()


class _Keyed:
    """Namespaced view over a shared :class:`SpillCache`."""

    def __init__(self, cache: SpillCache, tag: str):
        self._cache, self._tag = cache, tag

    def __getitem__(self, vid):
        return self._cache[(self._tag, vid)]

    def __setitem__(self, vid, arr) -> None:
        self._cache[(self._tag, vid)] = arr


def fuse_scan(metas: list[tuple[int, list[int]]],
              read_image: Callable[[int], np.ndarray],
              read_depth: Callable[[int], np.ndarray],
              read_proba: Callable[[int], np.ndarray],
              proj_mat: Callable[[int], np.ndarray],
              img_wh: tuple[int, int],
              conf: float = 0.999, min_geo_consistent: int = 5,
              max_ref_views: int = 400, skip: int = 1,
              progress: bool = False, cache_bytes: float | None = 4e9,
              device="cuda"):
    """Fuse one scan. metas: [(ref_vid, src_vids), ...].

    read_image(vid) -> (H, W, 3) RGB uint8 at img_wh;
    read_depth(vid) -> (H, W) float32 (raises FileNotFoundError for a view
    without a prediction, which is then skipped);
    read_proba(vid) -> quarter-resolution confidence; proj_mat(vid) ->
    (4, 4). ``cache_bytes`` bounds the host RAM of the refined depth and
    image cache, whose overflow spills to disk; None keeps everything in
    memory.
    Returns (xyz (N, 3) float32, rgb (N, 3) uint8) numpy arrays.
    """
    device = torch.device(device)

    def put(arr: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    vs, v_colors = [], []
    with SpillCache(max_bytes=cache_bytes) as cache:
        refined_images = _Keyed(cache, "img")
        refined_depths = _Keyed(cache, "dep")
        refined: set[int] = set()
        todo = metas[:max_ref_views]

        for i, (ref_vid, src_vids) in enumerate(todo):
            try:
                if ref_vid in refined:
                    image_ref = refined_images[ref_vid]
                    depth_ref = refined_depths[ref_vid]
                else:
                    image_ref = read_image(ref_vid)
                    depth_ref = read_depth(ref_vid)
                depth_ref = put(depth_ref)
                proba = upsample_proba(put(read_proba(ref_vid)), img_wh)
                mask_conf = proba > conf
                P_ref = proj_mat(ref_vid)

                mask_geo_sum = torch.zeros(depth_ref.shape,
                                           dtype=torch.int32, device=device)
                depth_acc = depth_ref.clone()
                color_acc = put(image_ref).float()
                for src_vid in src_vids:
                    if src_vid in refined:
                        image_src = refined_images[src_vid]
                        depth_src = refined_depths[src_vid]
                    else:
                        image_src = read_image(src_vid)
                        depth_src = read_depth(src_vid)
                        # the raw depth is cached, as for a reference
                        refined_depths[src_vid] = depth_src
                    d_reproj, m_geo, img_reproj = check_geo_consistency(
                        depth_ref, P_ref, put(depth_src), proj_mat(src_vid),
                        put(image_src).float())
                    mask_geo_sum += m_geo
                    depth_acc += d_reproj
                    color_acc += img_reproj

                # the mean in float64, as numpy divides float32 by int32
                count = (mask_geo_sum + 1).double()
                depth_refined = (depth_acc / count).float()
                image_refined = color_acc / count[..., None]
                refined_depths[ref_vid] = depth_refined.cpu().numpy()
                refined_images[ref_vid] = image_refined.clamp(0, 255).to(
                    torch.uint8).cpu().numpy()
                refined.add(ref_vid)

                mask_final = mask_conf & (mask_geo_sum
                                          >= min_geo_consistent)
                xyz, rgb = backproject(depth_refined, mask_final,
                                       image_refined, P_ref, skip)
                vs.append(xyz)
                v_colors.append(rgb)
                if progress:
                    print(f"fused view {ref_vid} ({i + 1}/{len(todo)}): "
                          f"{len(xyz)} points", flush=True)
            except FileNotFoundError:
                # views with too few valid sources have no depth prediction
                print(f"Skipping view {ref_vid}: missing depth prediction")

    if not vs:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8))
    return np.vstack(vs), np.vstack(v_colors)


def fuse_and_write(out_path: str, *args, **kwargs) -> int:
    """Run :func:`fuse_scan` and write a binary PLY; returns #points."""
    xyz, rgb = fuse_scan(*args, **kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_ply(out_path, xyz, rgb)
    return len(xyz)
