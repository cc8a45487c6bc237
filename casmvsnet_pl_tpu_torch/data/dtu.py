"""DTU multi-view-stereo dataset reader.

The port's counterpart of ``casmvsnet_pl_tpu/data/dtu.py``: the same
protocol and samples, read without PIL or OpenCV (``data/png.py``,
``data/base.py``), with its own copy of the split lists (``lists/dtu``):
  - train/val: 49 views x 7 lighting conditions per scan; images come
    pre-rectified at 640x512; GT depth PFMs at 1600x1200 are half-resized and
    cropped to the fixed 640x512 window [44:556, 80:720]; visibility masks
    likewise; 3-level nearest pyramids.
  - test: lighting 3 only, arbitrary ``img_wh`` (multiples of 32), no GT;
    intrinsics rescaled from the native 1600x1200.
  - cameras: train split reads ``Cameras/train/*_cam.txt`` (already at 1/4 of
    640x512), test reads ``Cameras/*_cam.txt`` (native res).
  - per-sample relative projections src @ inv(ref) per pyramid level.
"""
from __future__ import annotations

import os

import numpy as np

from .base import (depth_pyramid, load_image, mask_pyramid, normalize_image,
                   resize_nearest)
from .cams import (build_level_proj_mats, read_cam_file, read_pair_file,
                   relative_proj_mats, scale_intrinsics_to_coarsest)
from .pfm import read_pfm
from .png import read_png, to_grey

_LISTS_DIR = os.path.join(os.path.dirname(__file__), "lists", "dtu")


class DTUDataset:
    """Yields numpy sample dicts; see data/base.py for the schema.

    The DTU protocol constants are class attributes so tests can exercise the
    exact same code paths on miniature synthetic trees (data/synthetic.py).
    """
    NATIVE_WH = (1600, 1200)        # native image/depth resolution (test cams)
    DEPTH_CROP = ((44, 556), (80, 720))  # (rows, cols) crop after 0.5x resize
    N_CAMS = 49                     # shared camera rig size
    LISTS_DIR = _LISTS_DIR

    def __init__(self, root_dir: str, split: str, n_views: int = 3,
                 levels: int = 3, depth_interval: float = 2.65,
                 img_wh: tuple[int, int] | None = None):
        if split not in ("train", "val", "test"):
            raise ValueError(f'split must be "train", "val" or "test", got '
                             f'{split!r}')
        if img_wh is not None and (img_wh[0] % 32 or img_wh[1] % 32):
            raise ValueError(f"img_wh must be multiples of 32, got {img_wh}")
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.levels = levels
        self.depth_interval = depth_interval
        self.img_wh = tuple(img_wh) if img_wh is not None else None
        self.build_metas()
        self.build_proj_mats()

    # -- metadata ----------------------------------------------------------
    def build_metas(self):
        with open(os.path.join(self.LISTS_DIR, f"{self.split}.txt")) as f:
            self.scans = [line.rstrip() for line in f if line.strip()]
        light_idxs = [3] if self.img_wh is not None else range(7)
        pair_path = os.path.join(self.root_dir, "Cameras/pair.txt")
        pairs = read_pair_file(pair_path)
        self.metas = []
        for scan in self.scans:
            for ref_view, src_views, _ in pairs:
                for light_idx in light_idxs:
                    self.metas.append((scan, light_idx, ref_view, src_views))

    def build_proj_mats(self):
        """DTU shares one camera rig across scans: 49 cam files."""
        self.proj_mats = []
        for vid in range(self.N_CAMS):
            if self.img_wh is None:
                cam_path = os.path.join(self.root_dir,
                                        f"Cameras/train/{vid:08d}_cam.txt")
                intrinsics, extrinsics, depth_min = read_cam_file(cam_path)
            else:
                cam_path = os.path.join(self.root_dir,
                                        f"Cameras/{vid:08d}_cam.txt")
                intrinsics, extrinsics, depth_min = read_cam_file(cam_path)
                intrinsics = scale_intrinsics_to_coarsest(
                    intrinsics, self.NATIVE_WH, self.img_wh)
            mats = build_level_proj_mats(intrinsics, extrinsics, self.levels)
            self.proj_mats.append((mats, depth_min))

    # -- per-view IO -------------------------------------------------------
    def _image_path(self, scan: str, vid: int, light_idx: int) -> str:
        # image file ids are 1-based
        if self.img_wh is None:
            return os.path.join(
                self.root_dir,
                f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light_idx}_r5000.png")
        return os.path.join(
            self.root_dir,
            f"Rectified/{scan}/rect_{vid + 1:03d}_{light_idx}_r5000.png")

    def read_depth(self, scan: str, vid: int) -> dict[str, np.ndarray]:
        path = os.path.join(self.root_dir,
                            f"Depths/{scan}/depth_map_{vid:04d}.pfm")
        depth = read_pfm(path)[0]                                  # (1200, 1600)
        if self.img_wh is None:
            (r0, r1), (c0, c1) = self.DEPTH_CROP
            depth_0 = depth[::2, ::2][r0:r1, c0:c1]                # (512, 640)
        else:
            depth_0 = resize_nearest(depth, self.img_wh)
        return depth_pyramid(depth_0, self.levels)

    def read_mask(self, scan: str, vid: int) -> dict[str, np.ndarray]:
        path = os.path.join(self.root_dir,
                            f"Depths/{scan}/depth_visual_{vid:04d}.png")
        mask = to_grey(read_png(path))
        if self.img_wh is None:
            (r0, r1), (c0, c1) = self.DEPTH_CROP
            mask_0 = mask[::2, ::2][r0:r1, c0:c1]
        else:
            mask_0 = resize_nearest(mask, self.img_wh)
        return mask_pyramid(mask_0 > 0, self.levels)

    def image_path(self, scan: str, vid: int) -> str:
        """The view's image that fusion colours its points from (light 3,
        as ``eval.py``)."""
        return os.path.join(
            self.root_dir, f"Rectified/{scan}/rect_{vid + 1:03d}_3_r5000.png")

    def proj_mat(self, scan: str, vid: int) -> np.ndarray:
        """The view's full-resolution (level 0) 4x4 projection."""
        return self.proj_mats[vid][0][0]

    # -- sequence protocol -------------------------------------------------
    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        scan, light_idx, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.n_views - 1]

        sample: dict = {}
        imgs, src_mats = [], []
        ref_mats = None
        for i, vid in enumerate(view_ids):
            img = load_image(self._image_path(scan, vid, light_idx),
                             self.img_wh)
            imgs.append(normalize_image(img))
            mats, depth_min = self.proj_mats[vid]
            if i == 0:
                ref_mats = mats
                sample["init_depth_min"] = np.float32(depth_min)
                if self.img_wh is None:
                    sample["masks"] = self.read_mask(scan, vid)
                    sample["depths"] = self.read_depth(scan, vid)
            else:
                src_mats.append(mats)

        sample["imgs"] = np.stack(imgs)                       # (V, H, W, 3)
        sample["proj_mats"] = relative_proj_mats(
            ref_mats, np.stack(src_mats))                     # (V-1, L, 3, 4)
        sample["depth_interval"] = np.float32(self.depth_interval)
        sample["scan_vid"] = (scan, ref_view)
        return sample
