"""Synthetic plane scene with exact ground truth, numpy and torch only.

Counterpart of ``casmvsnet_pl_tpu/data/synthetic.py``. A textured plane
z = z0 + slope_x * X is seen by V cameras translated along x with identity
rotation. The texture's cubic upsample uses ``F.interpolate(mode=
"bicubic")`` in place of OpenCV, so the images are alike but not bit-equal
to the JAX package's; the geometry (depths, cameras, surface points) is
the same. ``write_dtu_tree`` materializes the scene in DTU's on-disk format
(pair.txt, cam.txt, PFM depths, mask PNGs, rectified PNGs);
``write_blendedmvs_tree`` and ``write_tanks_tree`` in those datasets'
layouts, with JPEGs from ``data/jpeg.py::encode_jpeg`` (cv2.imwrite's file).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .base import IMAGENET_MEAN, IMAGENET_STD, resize_nearest
from .cams import relative_proj_mats
from .jpeg import write_jpeg
from .pfm import save_pfm
from .png import write_png


def _smooth_texture(rng: np.random.RandomState, size: int = 64,
                    upsample: int = 8) -> np.ndarray:
    """Smooth random RGB texture in [0, 1], (size*upsample,)*2 + (3,)."""
    base = torch.from_numpy(rng.rand(size, size, 3).astype(np.float32))
    big = F.interpolate(base.permute(2, 0, 1)[None],
                        size=(size * upsample, size * upsample),
                        mode="bicubic", align_corners=False)
    return big[0].permute(1, 2, 0).clamp(0, 1).numpy()


def _sample_texture(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample tex at float texture coords (u, v), clamped."""
    H, W = tex.shape[:2]
    u = np.clip(u, 0, W - 1.001)
    v = np.clip(v, 0, H - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)


class PlaneScene:
    """A textured plane z = z0 + slope_x * X viewed by V translated cameras."""

    def __init__(self, img_wh=(64, 64), n_views: int = 3, z0: float = 500.0,
                 baseline: float = 10.0, focal: float = 100.0,
                 slope_x: float = 0.0, seed: int = 0):
        self.img_wh = img_wh
        self.n_views = n_views
        self.z0 = z0
        self.baseline = baseline
        self.focal = focal
        self.slope_x = slope_x
        self.texture = _smooth_texture(np.random.RandomState(seed))
        W, H = img_wh
        self.K = np.array([[focal, 0, (W - 1) / 2],
                           [0, focal, (H - 1) / 2],
                           [0, 0, 1]], np.float32)
        # world -> camera: camera v sits at (v * baseline, 0, 0)
        self.extrinsics = []
        for v in range(n_views):
            E = np.eye(4, dtype=np.float32)
            E[0, 3] = -v * baseline
            self.extrinsics.append(E)

    def depth_map(self, view: int) -> np.ndarray:
        """Ground-truth depth (camera z) of one view, (H, W) float32."""
        W, H = self.img_wh
        u = np.arange(W, dtype=np.float32)[None].repeat(H, 0)
        return self.depth_at(view, u)

    def depth_at(self, view: int, u: np.ndarray) -> np.ndarray:
        """Depth of one view at image columns ``u`` (any shape, float; the
        plane's depth depends on the column only), float32."""
        dir_x = (u - self.K[0, 2]) / self.focal
        z = ((self.z0 + self.slope_x * view * self.baseline)
             / (1.0 - self.slope_x * dir_x))
        return z.astype(np.float32)

    def render(self, view: int) -> np.ndarray:
        """Float RGB in [0, 1], (H, W, 3)."""
        W, H = self.img_wh
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        cx, cy, f = self.K[0, 2], self.K[1, 2], self.focal
        z = self.depth_map(view)
        Xw = (u - cx) / f * z + view * self.baseline
        Yw = (v - cy) / f * z
        th, tw = self.texture.shape[:2]
        tu = (Xw / self.z0 + 0.5) * (tw - 1)
        tv = (Yw / self.z0 + 0.5) * (th - 1)
        return _sample_texture(self.texture, tu, tv).astype(np.float32)

    def surface_points(self, step: int = 1) -> np.ndarray:
        """Exact surface points (world frame, scene units), float64 (N, 3):
        every ``step``-th pixel of every view's closed-form depth map
        backprojected. Their union is the observed surface, the ground
        truth against which clouds fused from this scene are scored
        (``evaluation/dtu_eval.py``)."""
        W, H = self.img_wh
        cx, cy, f = self.K[0, 2], self.K[1, 2], self.focal
        u, v = np.meshgrid(np.arange(0, W, step, dtype=np.float32),
                           np.arange(0, H, step, dtype=np.float32))
        pts = []
        for view in range(self.n_views):
            z = self.depth_map(view)[::step, ::step]
            X = (u - cx) / f * z + view * self.baseline
            Y = (v - cy) / f * z
            pts.append(np.stack([X, Y, z], axis=-1).reshape(-1, 3))
        return np.concatenate(pts).astype(np.float64)

    def proj_mats_level(self, level_scale: float = 1.0) -> np.ndarray:
        """Absolute 4x4 projections K_s @ E per view at a resolution scale."""
        K = self.K.copy()
        K[:2] *= level_scale
        mats = []
        for E in self.extrinsics:
            P = np.eye(4, dtype=np.float32)
            P[:3] = (K @ E[:3]).astype(np.float32)
            mats.append(P)
        return np.stack(mats)

    def model_inputs(self, levels: int = 3, normalize: bool = True):
        """(imgs (1, V, H, W, 3), proj_mats (1, V-1, L, 3, 4) fine -> coarse,
        {'level_l': (1, h, w)} ground-truth depth), all float32 numpy."""
        imgs = np.stack([self.render(v) for v in range(self.n_views)])
        if normalize:
            imgs = (imgs - IMAGENET_MEAN) / IMAGENET_STD
        abs_mats = np.stack(
            [self.proj_mats_level(0.5 ** l) for l in range(levels)], axis=1)
        rel = relative_proj_mats(abs_mats[0], abs_mats[1:])
        depth = self.depth_map(0)
        depths = {f"level_{l}": depth[None, ::2 ** l, ::2 ** l]
                  for l in range(levels)}
        return imgs[None].astype(np.float32), rel[None], depths


def write_dtu_tree(root: str, scans=("scan1", "scan2"), n_cams: int = 5,
                   img_wh=(64, 64), native_wh=(256, 256), seed: int = 0,
                   z0: float = 460.0, slope_x: float = 0.3,
                   focal: float = 100.0, lights=range(7),
                   depth_crop=None) -> None:
    """Write a DTU-format tree of a :class:`PlaneScene` for data-reader
    tests, as ``casmvsnet_pl_tpu/data/synthetic.py::write_dtu_tree`` does:
    rectified PNGs at ``img_wh`` for each light in ``lights``, in both the
    ``<scan>_train`` and the ``<scan>`` folder; native-resolution PFM depths
    and mask PNGs; per-view cam.txt at train (1/4 of img_wh) and test (1/4
    native) scales; a shared pair.txt. ``focal`` (pixels at ``img_wh``)
    keeps the field of view of the 64x64 default at larger sizes when it
    grows with the width.

    The native depths are the ``img_wh`` depths resized nearest, unless
    ``depth_crop`` ((r0, r1), (c0, c1)) is given: then native pixel
    (v, u) holds the plane's depth at image column u/2 - c0, so that the
    train split's half-resize and crop (``DTUDataset.DEPTH_CROP``) give
    depths that line up with the ``img_wh`` images, as DTU's do (its crop
    must be ``img_wh`` in size).
    """
    rng = np.random.RandomState(seed)
    W, H = img_wh
    os.makedirs(os.path.join(root, "Cameras/train"), exist_ok=True)

    # pair.txt: every view lists all the others, best-first
    with open(os.path.join(root, "Cameras/pair.txt"), "w") as f:
        f.write(f"{n_cams}\n")
        for ref in range(n_cams):
            srcs = [v for v in range(n_cams) if v != ref]
            f.write(f"{ref}\n{len(srcs)} " +
                    " ".join(f"{v} {100 - i}" for i, v in enumerate(srcs)) +
                    "\n")

    def write_cam(path, K, E, depth_min):
        with open(path, "w") as f:
            f.write("extrinsic\n")
            for row in E:
                f.write(" ".join(f"{x:.6f}" for x in row) + "\n")
            f.write("\nintrinsic\n")
            for row in K:
                f.write(" ".join(f"{x:.6f}" for x in row) + "\n")
            f.write(f"\n{depth_min} 2.5\n")

    scene = PlaneScene(img_wh=img_wh, n_views=n_cams, seed=seed, z0=z0,
                       slope_x=slope_x, focal=focal)
    for vid in range(n_cams):
        E = scene.extrinsics[vid]
        K_train = scene.K.copy()
        K_train[:2] /= 4                       # train cams: 1/4 of img_wh
        write_cam(os.path.join(root, f"Cameras/train/{vid:08d}_cam.txt"),
                  K_train, E, 425.0)
        K_test = scene.K.copy()                # test cams: native resolution
        K_test[0] *= native_wh[0] / W
        K_test[1] *= native_wh[1] / H
        write_cam(os.path.join(root, f"Cameras/{vid:08d}_cam.txt"),
                  K_test, E, 425.0)

    for scan in scans:
        for sub in (f"Rectified/{scan}_train", f"Rectified/{scan}",
                    f"Depths/{scan}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for vid in range(n_cams):
            img = (scene.render(vid) * 255).astype(np.uint8)
            for light in lights:
                shade = np.clip(img.astype(np.int32) + (light - 3) * 5,
                                0, 255).astype(np.uint8)
                for sub in (f"{scan}_train", scan):
                    write_png(os.path.join(
                        root, f"Rectified/{sub}/"
                        f"rect_{vid + 1:03d}_{light}_r5000.png"), shade)
            # native-resolution depth and visibility mask
            if depth_crop is None:
                depth = resize_nearest(scene.depth_map(vid), native_wh)
            else:
                (r0, r1), (c0, c1) = depth_crop
                if (c1 - c0, r1 - r0) != tuple(img_wh):
                    raise ValueError(f"depth_crop {depth_crop} is not "
                                     f"img_wh {img_wh} in size")
                u = np.arange(native_wh[0], dtype=np.float32) / 2 - c0
                depth = np.repeat(scene.depth_at(vid, u)[None],
                                  native_wh[1], 0)
            save_pfm(os.path.join(root,
                                  f"Depths/{scan}/depth_map_{vid:04d}.pfm"),
                     depth)
            mask = (rng.rand(native_wh[1], native_wh[0]) > 0.1
                    ).astype(np.uint8) * 255
            write_png(os.path.join(
                root, f"Depths/{scan}/depth_visual_{vid:04d}.png"), mask)


def _write_pairs(path: str, n_cams: int, n_src: int = 10) -> None:
    """pair.txt: each view lists its ``n_src`` nearest views on the rig,
    best first."""
    with open(path, "w") as f:
        f.write(f"{n_cams}\n")
        for ref in range(n_cams):
            srcs = sorted((v for v in range(n_cams) if v != ref),
                          key=lambda v: (abs(v - ref), v))[:n_src]
            f.write(f"{ref}\n{len(srcs)} " +
                    " ".join(f"{v} {100.0 - i:.1f}" for i, v in
                             enumerate(srcs)) + "\n")


def _write_cam(path: str, K: np.ndarray, E: np.ndarray, depth_line: str
               ) -> None:
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in E:
            f.write(" ".join(f"{x:.9g}" for x in row) + "\n")
        f.write("\nintrinsic\n")
        for row in K:
            f.write(" ".join(f"{x:.9g}" for x in row) + "\n")
        f.write(f"\n{depth_line}\n")


def write_blendedmvs_tree(root: str, n_cams: int = 10, img_wh=(768, 576),
                          z0: float = 460.0) -> str:
    """Write a BlendedMVS-format tree of a :class:`PlaneScene` for a train
    scene (``synth_train``) and a val scene (``synth_val``) and return the
    reader's root, ``<root>/dataset_low_res``: the split lists
    ``{training,validation,all}_list.txt`` in ``root``; per scene
    ``blended_images/*.jpg`` (cv2.imwrite's JPEGs at ``img_wh``, the
    native size), ``rendered_depth_maps/*.pfm``, ``cams/*_cam.txt``
    (depth_min 0.8 * z0, then interval, count and depth_max as BlendedMVS
    writes them) and ``cams/pair.txt``. The field of view is the 64x64
    scene's (100 px at 64 wide); the scenes' textures are seeded 0 and
    1."""
    W = img_wh[0]
    data_root = os.path.join(root, "dataset_low_res")
    splits = {"training_list.txt": ["synth_train"],
              "validation_list.txt": ["synth_val"],
              "all_list.txt": ["synth_train", "synth_val"]}
    os.makedirs(data_root, exist_ok=True)
    for name, items in splits.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("".join(f"{s}\n" for s in items))
    for k, scan in enumerate(splits["all_list.txt"]):
        for sub in ("blended_images", "rendered_depth_maps", "cams"):
            os.makedirs(os.path.join(data_root, scan, sub), exist_ok=True)
        scene = PlaneScene(img_wh=img_wh, n_views=n_cams, seed=k, z0=z0,
                           slope_x=0.3, focal=100.0 * W / 64)
        _write_pairs(os.path.join(data_root, scan, "cams/pair.txt"), n_cams)
        d_min = 0.8 * z0
        for vid in range(n_cams):
            _write_cam(os.path.join(data_root, scan,
                                    f"cams/{vid:08d}_cam.txt"),
                       scene.K, scene.extrinsics[vid],
                       f"{d_min} {(1.2 * z0 - d_min) / 128} 128 {1.2 * z0}")
            save_pfm(os.path.join(data_root, scan,
                                  f"rendered_depth_maps/{vid:08d}.pfm"),
                     scene.depth_map(vid))
            write_jpeg(os.path.join(data_root, scan,
                                    f"blended_images/{vid:08d}.jpg"),
                       (scene.render(vid) * 255).astype(np.uint8))
    return data_root


def write_tanks_tree(root: str, split: str = "intermediate",
                     image_scans=("Family",), n_cams: int = 5,
                     z0: float = 1.0, slope_x: float = 0.1,
                     baseline: float = 0.05, image_scale: float = 1.0
                     ) -> None:
    """Write a Tanks-and-Temples-format tree under ``<root>/<split>``: for
    every scan of the split (the reader reads each one's cameras) a
    ``pair.txt`` and ``cams/*_cam.txt`` at the scan's native size, and for
    the scans of ``image_scans`` ``images/*.jpg`` of a :class:`PlaneScene`
    (cv2.imwrite's JPEGs) at the native size times ``image_scale``. The
    scene sits at depth ``z0`` (scene units, like Tanks' own) and every
    camera's depth_min is 0.8 * z0, so that the swept range (Family:
    48 * 4 * 2.5e-3 = 0.48 units at the coarsest level) holds it; each
    scan's texture is seeded with its index."""
    from .tanks import (ADVANCED_SCANS, ADVANCED_SIZES, INTERMEDIATE_SCANS,
                        INTERMEDIATE_SIZES)
    scans, sizes = ((INTERMEDIATE_SCANS, INTERMEDIATE_SIZES)
                    if split == "intermediate"
                    else (ADVANCED_SCANS, ADVANCED_SIZES))
    for k, scan in enumerate(scans):
        W, H = sizes[scan]
        img_wh = (round(W * image_scale), round(H * image_scale))
        scene = PlaneScene(img_wh=img_wh, n_views=n_cams, seed=k,
                           z0=z0, slope_x=slope_x,
                           focal=1.2 * img_wh[0], baseline=baseline)
        K = scene.K.copy()
        K[0] *= W / img_wh[0]                 # cameras at the native size
        K[1] *= H / img_wh[1]
        scan_dir = os.path.join(root, split, scan)
        os.makedirs(os.path.join(scan_dir, "cams"), exist_ok=True)
        _write_pairs(os.path.join(scan_dir, "pair.txt"), n_cams)
        for vid in range(n_cams):
            _write_cam(os.path.join(scan_dir, f"cams/{vid:08d}_cam.txt"), K,
                       scene.extrinsics[vid], f"{0.8 * z0} {z0 / 400}")
        if scan in image_scans:
            os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
            for vid in range(n_cams):
                write_jpeg(os.path.join(scan_dir, f"images/{vid:08d}.jpg"),
                           (scene.render(vid) * 255).astype(np.uint8))
