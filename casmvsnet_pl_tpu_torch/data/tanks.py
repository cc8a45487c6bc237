"""Tanks and Temples dataset reader (test only).

The port's counterpart of ``casmvsnet_pl_tpu/data/tanks.py``, with the same
protocol and samples, read without PIL (``data/jpeg.py``): fixed scan lists
for the intermediate and advanced splits, per-scan native image sizes and
hand-tuned per-scan depth intervals (the ``depth_interval`` argument is
ignored); cameras and pairs per scan under
``<root>/<split>/<scan>/{cams,pair.txt}``, images under ``images/``.
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from .base import load_image, normalize_image
from .cams import (build_level_proj_mats, read_cam_file, read_pair_file,
                   relative_proj_mats, scale_intrinsics_to_coarsest)

INTERMEDIATE_SCANS = ["Family", "Francis", "Horse", "Lighthouse",
                      "M60", "Panther", "Playground", "Train"]
INTERMEDIATE_SIZES = {"Family": (1920, 1080), "Francis": (1920, 1080),
                      "Horse": (1920, 1080), "Lighthouse": (2048, 1080),
                      "M60": (2048, 1080), "Panther": (2048, 1080),
                      "Playground": (1920, 1080), "Train": (1920, 1080)}
INTERMEDIATE_INTERVALS = {"Family": 2.5e-3, "Francis": 1e-2, "Horse": 1.5e-3,
                          "Lighthouse": 1.5e-2, "M60": 5e-3, "Panther": 5e-3,
                          "Playground": 7e-3, "Train": 5e-3}
ADVANCED_SCANS = ["Auditorium", "Ballroom", "Courtroom",
                  "Museum", "Palace", "Temple"]
ADVANCED_SIZES = {s: (1920, 1080) for s in ADVANCED_SCANS}
ADVANCED_INTERVALS = {"Auditorium": 3e-2, "Ballroom": 2e-2, "Courtroom": 2e-2,
                      "Museum": 2e-2, "Palace": 1e-2, "Temple": 1e-2}


class TanksDataset:
    def __init__(self, root_dir: str, split: str = "intermediate",
                 n_views: int = 3, levels: int = 3, depth_interval: float = -1,
                 img_wh: tuple[int, int] = (1152, 864)):
        """depth_interval is ignored: intervals are predefined per scan."""
        assert split in ("intermediate", "advanced")
        assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0, \
            "img_wh must be multiples of 32"
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.levels = levels
        self.img_wh = tuple(img_wh)
        if split == "intermediate":
            self.scans = list(INTERMEDIATE_SCANS)
            self.image_sizes = dict(INTERMEDIATE_SIZES)
            self.depth_interval = dict(INTERMEDIATE_INTERVALS)
        else:
            self.scans = list(ADVANCED_SCANS)
            self.image_sizes = dict(ADVANCED_SIZES)
            self.depth_interval = dict(ADVANCED_INTERVALS)
        self.build_metas()
        self.build_proj_mats()

    def build_metas(self):
        self.metas = []
        self.ref_views_per_scan = defaultdict(list)
        for scan in self.scans:
            pairs = read_pair_file(
                os.path.join(self.root_dir, self.split, scan, "pair.txt"))
            for ref_view, src_views, _ in pairs:
                self.metas.append((scan, -1, ref_view, src_views))
                self.ref_views_per_scan[scan].append(ref_view)

    def build_proj_mats(self):
        self.proj_mats: dict[str, dict[int, tuple[np.ndarray, float]]] = {}
        for scan in self.scans:
            self.proj_mats[scan] = {}
            native_wh = self.image_sizes[scan]
            for vid in self.ref_views_per_scan[scan]:
                cam_path = os.path.join(self.root_dir, self.split, scan,
                                        f"cams/{vid:08d}_cam.txt")
                intrinsics, extrinsics, depth_min = read_cam_file(cam_path)
                intrinsics = scale_intrinsics_to_coarsest(
                    intrinsics, native_wh, self.img_wh)
                mats = build_level_proj_mats(intrinsics, extrinsics,
                                             self.levels)
                self.proj_mats[scan][vid] = (mats, depth_min)

    def image_path(self, scan: str, vid: int) -> str:
        return os.path.join(self.root_dir, self.split, scan,
                            f"images/{vid:08d}.jpg")

    def proj_mat(self, scan: str, vid: int) -> np.ndarray:
        """The view's full-resolution (level 0) 4x4 projection."""
        return self.proj_mats[scan][vid][0][0]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        scan, _, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[:self.n_views - 1]

        sample: dict = {}
        imgs, src_mats = [], []
        ref_mats = None
        for i, vid in enumerate(view_ids):
            img = load_image(self.image_path(scan, vid), self.img_wh)
            imgs.append(normalize_image(img))
            mats, depth_min = self.proj_mats[scan][vid]
            if i == 0:
                ref_mats = mats
                sample["init_depth_min"] = np.float32(depth_min)
                sample["depth_interval"] = np.float32(
                    self.depth_interval[scan])
            else:
                src_mats.append(mats)

        sample["imgs"] = np.stack(imgs)
        sample["proj_mats"] = relative_proj_mats(ref_mats, np.stack(src_mats))
        sample["scan_vid"] = (scan, ref_view)
        return sample
