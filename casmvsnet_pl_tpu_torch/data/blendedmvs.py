"""BlendedMVS dataset reader.

The port's counterpart of ``casmvsnet_pl_tpu/data/blendedmvs.py``, with the
same protocol and samples, read without PIL or OpenCV (``data/jpeg.py``,
``data/base.py``):
  - scene lists from ``{training,validation,all}_list.txt`` one level above
    the scene root;
  - reference views with fewer than ``n_views`` valid sources are skipped;
  - native size 768x576 under a root ending in ``dataset_low_res``, else
    2048x1536;
  - per-scene depth rescaling: the first camera's depth_min sets
    scale = 100 / depth_min, applied to depth_min, the extrinsic translation
    and GT depths;
  - the ``depth_interval`` constructor arg is reinterpreted as the *total
    number of depth hypotheses*: per sample,
    interval = (depth_max - depth_min) / depth_interval;
  - GT depth resized with OpenCV's nearest rule; masks are depth > depth_min;
  - brightness/contrast jitter on the train split from one
    ``np.random.RandomState(seed)`` shared by every sample (ordered only
    when samples are read one after another).
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from .base import (color_jitter, depth_pyramid, load_image, normalize_image,
                   resize_nearest)
from .cams import (build_level_proj_mats, read_cam_file, read_pair_file,
                   relative_proj_mats, scale_intrinsics_to_coarsest)
from .pfm import read_pfm


class BlendedMVSDataset:
    def __init__(self, root_dir: str, split: str, n_views: int = 3,
                 levels: int = 3, depth_interval: float = 192.0,
                 img_wh: tuple[int, int] = (768, 576), seed: int = 0):
        assert split in ("train", "val", "all"), \
            'split must be "train", "val" or "all"'
        assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0, \
            "img_wh must be multiples of 32"
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.levels = levels
        self.n_depths_total = depth_interval  # reinterpreted (see docstring)
        self.img_wh = tuple(img_wh)
        self._rng = np.random.RandomState(seed)
        self.build_metas()
        self.build_proj_mats()

    def build_metas(self):
        list_name = {"train": "training_list.txt",
                     "val": "validation_list.txt",
                     "all": "all_list.txt"}[self.split]
        with open(os.path.join(self.root_dir, "..", list_name)) as f:
            self.scans = [line.rstrip() for line in f if line.strip()]
        self.metas = []
        self.ref_views_per_scan = defaultdict(list)
        for scan in self.scans:
            pairs = read_pair_file(
                os.path.join(self.root_dir, scan, "cams/pair.txt"))
            for ref_view, src_views, n_valid in pairs:
                self.ref_views_per_scan[scan].append(ref_view)
                if n_valid < self.n_views:
                    continue
                self.metas.append((scan, -1, ref_view, src_views))

    def _native_wh(self) -> tuple[int, int]:
        root = self.root_dir.rstrip("/")
        if root.endswith("dataset_low_res"):
            return (768, 576)
        return (2048, 1536)

    def build_proj_mats(self):
        self.proj_mats: dict[str, dict[int, tuple[np.ndarray, float]]] = {}
        self.scale_factors: dict[str, float] = {}
        native_wh = self._native_wh()
        for scan in self.scans:
            self.proj_mats[scan] = {}
            for vid in self.ref_views_per_scan[scan]:
                cam_path = os.path.join(self.root_dir, scan,
                                        f"cams/{vid:08d}_cam.txt")
                intrinsics, extrinsics, depth_min = read_cam_file(cam_path)
                if scan not in self.scale_factors:
                    # first camera fixes the scene's metric scale
                    self.scale_factors[scan] = 100.0 / depth_min
                sf = self.scale_factors[scan]
                depth_min *= sf
                extrinsics = extrinsics.copy()
                extrinsics[:3, 3] *= sf
                intrinsics = scale_intrinsics_to_coarsest(
                    intrinsics, native_wh, self.img_wh)
                mats = build_level_proj_mats(intrinsics, extrinsics,
                                             self.levels)
                self.proj_mats[scan][vid] = (mats, depth_min)

    def read_depth_and_mask(self, scan: str, vid: int, depth_min: float):
        path = os.path.join(self.root_dir, scan,
                            f"rendered_depth_maps/{vid:08d}.pfm")
        depth = read_pfm(path)[0] * self.scale_factors[scan]
        depth_0 = resize_nearest(depth, self.img_wh)
        depths = depth_pyramid(depth_0, self.levels)
        masks = {k: v > depth_min for k, v in depths.items()}
        return depths, masks, float(depth_0.max())

    def image_path(self, scan: str, vid: int) -> str:
        return os.path.join(self.root_dir, scan,
                            f"blended_images/{vid:08d}.jpg")

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
            if self.split == "train":
                img = color_jitter(img, self._rng)
            imgs.append(normalize_image(img))
            mats, depth_min = self.proj_mats[scan][vid]
            if i == 0:
                ref_mats = mats
                depths, masks, depth_max = self.read_depth_and_mask(
                    scan, vid, depth_min)
                sample["depths"], sample["masks"] = depths, masks
                sample["init_depth_min"] = np.float32(depth_min)
                sample["depth_interval"] = np.float32(
                    (depth_max - depth_min) / self.n_depths_total)
            else:
                src_mats.append(mats)

        sample["imgs"] = np.stack(imgs)
        sample["proj_mats"] = relative_proj_mats(ref_mats, np.stack(src_mats))
        sample["scan_vid"] = (scan, ref_view)
        return sample
