"""Seeded plane scenes, made on the device: the benchmark's inputs.

Each scene is a textured plane z = z0 + sx X + sy Y seen by V cameras on
the rig of ``bench.py::make_inputs``: identity rotation, camera v at
(v * baseline, 0, 0), focal ``focal`` pixels, principal point at the image
centre. z0, sx, sy and the texture differ from scene to scene, drawn from
the run's seed and the scene's index, so every seed gives the same sizes
and the same work, and a scene can be made again by index alone (the
reference rebuilds the batches it follows). The plane stays inside the
coarsest level's sweep (from ``init_depth_min``) for every draw.

Images are normalized with ImageNet's mean and deviation, as the data
readers do; projections are the per-level relative ones, src @ inv(ref),
fine to coarse; the ground-truth depth is the reference view's, subsampled
by 2^l at level l, with every pixel valid.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BASELINE = 12.0
Z0 = (500.0, 580.0)
SLOPE = 0.15
TEXTURE = 64            # texture noise, upsampled x8 (bicubic)


def scene_seed(seed: int, index: int) -> int:
    """A 63-bit seed of scene ``index`` under the run's ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * int(index) + 1) % (2 ** 63)


def scene_params(seed: int, index: int) -> tuple[float, float, float]:
    """(z0, sx, sy) of scene ``index``."""
    rng = np.random.default_rng(scene_seed(seed, index))
    z0 = float(rng.uniform(*Z0))
    sx, sy = (float(s) for s in rng.uniform(-SLOPE, SLOPE, 2))
    return z0, sx, sy


def _texture(seed: int, index: int, device) -> torch.Tensor:
    """(1, 3, 8T, 8T) smooth RGB texture in [0, 1]."""
    gen = torch.Generator(device=device).manual_seed(scene_seed(seed, index))
    noise = torch.rand((1, 3, TEXTURE, TEXTURE), generator=gen,
                       device=device)
    big = F.interpolate(noise, scale_factor=8, mode="bicubic",
                        align_corners=False)
    return big.clamp(0.0, 1.0)


def _ray(img_wh, focal: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    W, H = img_wh
    cx, cy = (W - 1) / 2, (H - 1) / 2
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)
    return ((u - cx) / focal)[None, :].expand(H, W), \
        ((v - cy) / focal)[:, None].expand(H, W)


def plane_depth(z0: float, sx: float, sy: float, view: int, img_wh,
                focal: float, device) -> torch.Tensor:
    """(H, W) depth of ``view`` (camera z) of the plane."""
    dx, dy = _ray(img_wh, focal, device)
    return (z0 + sx * view * BASELINE) / (1.0 - sx * dx - sy * dy)


def render_scene(seed: int, index: int, img_wh, n_views: int, focal: float,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images (V, H, W, 3) normalized, reference depth (H, W)), float32."""
    z0, sx, sy = scene_params(seed, index)
    tex = _texture(seed, index, device)
    dx, dy = _ray(img_wh, focal, device)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    views = []
    for v in range(n_views):
        z = plane_depth(z0, sx, sy, v, img_wh, focal, device)
        xw = v * BASELINE + z * dx
        yw = z * dy
        grid = torch.stack([1.4 * xw / z0, 1.4 * yw / z0], dim=-1)[None]
        rgb = F.grid_sample(tex, grid, mode="bilinear",
                            padding_mode="border", align_corners=True)
        views.append((rgb[0].permute(1, 2, 0) - mean) / std)
    depth = plane_depth(z0, sx, sy, 0, img_wh, focal, device)
    return torch.stack(views), depth


def proj_mats(n_views: int, focal: float, levels: int, device
              ) -> torch.Tensor:
    """(V-1, levels, 3, 4) relative projections src @ inv(ref), fine to
    coarse: [I | (-f 2^-l v b, 0, 0)] on this rig."""
    out = torch.zeros((n_views - 1, levels, 3, 4), dtype=torch.float32,
                      device=device)
    for v in range(1, n_views):
        for l in range(levels):
            out[v - 1, l, :, :3] = torch.eye(3, device=device)
            out[v - 1, l, 0, 3] = -focal * 0.5 ** l * v * BASELINE
    return out


def make_batch(seed: int, indices, img_wh, n_views: int, focal: float,
               config: dict, device) -> dict:
    """The batch of scenes ``indices``, as ``MVSTrainer.device_batch`` gives
    one: imgs (B, V, H, W, 3), proj_mats (B, V-1, L, 3, 4), init_depth_min
    and depth_interval (B,), depths and masks {'level_l': (B, h, w)}."""
    levels = config["levels"]
    imgs, depths = zip(*(render_scene(seed, i, img_wh, n_views, focal, device)
                         for i in indices))
    depth = torch.stack(depths)
    B = len(indices)
    proj = proj_mats(n_views, focal, levels, device)
    return {
        "imgs": torch.stack(imgs).contiguous(),
        "proj_mats": proj[None].expand(B, -1, -1, -1, -1).contiguous(),
        "init_depth_min": torch.full((B,), config["init_depth_min"],
                                     dtype=torch.float32, device=device),
        "depth_interval": torch.full((B,), config["depth_interval"],
                                     dtype=torch.float32, device=device),
        "depths": {f"level_{l}": depth[:, ::2 ** l, ::2 ** l].contiguous()
                   for l in range(levels)},
        "masks": {f"level_{l}": torch.ones_like(depth[:, ::2 ** l, ::2 ** l],
                                                dtype=torch.bool)
                  for l in range(levels)},
    }
