"""Synthetic plane scene with exact ground truth, numpy and torch only.

Counterpart of ``casmvsnet_pl_tpu/data/synthetic.py::PlaneScene`` (the
parts that build model inputs). A textured plane z = z0 + slope_x * X is
seen by V cameras translated along x with identity rotation. The texture's
cubic upsample uses ``F.interpolate(mode="bicubic")`` in place of OpenCV, so
the images are alike but not bit-equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics, as in casmvsnet_pl_tpu/data/base.py
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


def relative_proj_mats(ref_proj: np.ndarray, src_projs: np.ndarray) -> np.ndarray:
    """src @ inv(ref) per level, top 3 rows.

    ref_proj: (L, 4, 4); src_projs: (V-1, L, 4, 4) -> (V-1, L, 3, 4).
    """
    ref_inv = np.linalg.inv(ref_proj.astype(np.float64))
    rel = np.einsum("vlij,ljk->vlik", src_projs.astype(np.float64), ref_inv)
    return rel[:, :, :3].astype(np.float32)


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
