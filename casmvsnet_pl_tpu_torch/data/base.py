"""Shared dataset machinery: image loading and normalization, resizes,
depth and mask pyramids.

The port's counterpart of ``casmvsnet_pl_tpu/data/base.py``, free of PIL
and OpenCV. :func:`load_image` reads PNGs (``data/png.py``) and JPEGs
(``data/jpeg.py``) to the pixels PIL gives, :func:`load_image_cv2` to
those ``cv2.imread`` gives. The resamplers reproduce the ones the JAX
package calls:
- :func:`resize_bilinear_pil`: PIL's ``BILINEAR`` resize of uint8 images,
  which feeds the model (``load_image``). On a downscale it is a separable
  triangle filter whose support widens with the scale (an antialiasing
  filter), with 22-bit fixed-point coefficients and rounding; the result
  equals PIL's.
- :func:`resize_nearest`: OpenCV's ``INTER_NEAREST``, source index
  ``floor(dst * (1 / (dst_size / src_size)))``; the x0.5 pyramid step is
  ``[::2, ::2]``.
- :func:`resize_linear`: OpenCV's ``INTER_LINEAR`` semantics (half-pixel
  centres, edges replicated, no antialias), in float on a tensor's device.

Samples are numpy dicts, channels-last: ``imgs``, ``proj_mats``,
``depths``, ``masks``, ``init_depth_min``, ``depth_interval``,
``scan_vid``; ``data/loader.py`` batches them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .jpeg import decode_jpeg, is_jpeg, orient
from .native import image_lib
from .png import decode_png, to_rgb

# ImageNet statistics, as in the reference transforms
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_PRECISION_BITS = 22          # PIL's fixed-point coefficients for 8 bits


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 normalized (H, W, 3), channels-last."""
    img = img.astype(np.float32) / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def unnormalize_image(img: np.ndarray) -> np.ndarray:
    """Invert :func:`normalize_image` -> float in [0, 1]."""
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """PIL's triangle-filter taps for one axis: (first source index (out,),
    tap count (out,), fixed-point weights (out, ksize) int32)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    first = np.maximum(np.floor(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.floor(center + support + 0.5),
                       in_size).astype(np.int64) - first
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, ksize))
    total = np.zeros(out_size)
    for k in range(ksize):                    # summed in PIL's order
        w = np.maximum(1.0 - np.abs((k + first - center + 0.5) * ss), 0.0)
        weights[:, k] = np.where(k < count, w, 0.0)
        total += weights[:, k]
    weights /= np.where(total != 0.0, total, 1.0)[:, None]
    fixed = np.floor(0.5 + weights * (1 << _PRECISION_BITS)).astype(np.int32)
    return first, count, fixed


def _pil_resample_axis(img: np.ndarray, out_size: int, axis: int
                       ) -> np.ndarray:
    """One separable pass along ``axis`` of uint8 ``img``, rounded and
    clipped to uint8 as PIL's 8-bit pass (``image_native.c``)."""
    img = np.ascontiguousarray(img)
    first, count, fixed = _pil_bilinear_coeffs(img.shape[axis], out_size)
    outer = int(np.prod(img.shape[:axis]))
    inner = int(np.prod(img.shape[axis + 1:]))
    out = np.empty(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                   np.uint8)
    image_lib().resample_u8(img.reshape(-1), out.reshape(-1), outer,
                            img.shape[axis], inner, out_size, first, count,
                            np.ascontiguousarray(fixed), fixed.shape[1])
    return out


def resize_bilinear_pil(img: np.ndarray, img_wh: tuple[int, int]
                        ) -> np.ndarray:
    """uint8 (H, W[, C]) resized to ``img_wh`` (w, h) as PIL's
    ``Image.resize(img_wh, Image.BILINEAR)``: width first, then height."""
    w, h = img_wh
    if img.shape[1] != w:
        img = _pil_resample_axis(img, w, 1)
    if img.shape[0] != h:
        img = _pil_resample_axis(img, h, 0)
    return img


def load_image(path: str, img_wh: tuple[int, int] | None = None
               ) -> np.ndarray:
    """Read a PNG or a JPEG (told apart by their signatures, as PIL's
    ``Image.open`` does; a JPEG's EXIF orientation is ignored, as there)
    as RGB; optionally resize to (w, h) as PIL's BILINEAR. Returns uint8
    (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    img = to_rgb(decode_jpeg(data, path)[0] if is_jpeg(data)
                 else decode_png(data, path))
    if img_wh is not None:
        img = resize_bilinear_pil(img, tuple(img_wh))
    return img


def load_image_cv2(path: str) -> np.ndarray:
    """Read a PNG or a JPEG as RGB uint8 (H, W, 3) as
    ``cv2.imread(path)[..., ::-1]`` reads it: a JPEG is turned as its EXIF
    orientation says (``load_image`` ignores it, as PIL does)."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_jpeg(data):
        return to_rgb(decode_png(data, path))
    img, orientation = decode_jpeg(data, path)
    return orient(to_rgb(img), orientation)


def resize_nearest(img: np.ndarray, img_wh: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) resized to (w, h) as OpenCV's ``INTER_NEAREST``."""
    (w, h), (H, W) = img_wh, img.shape[:2]
    cols = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))), W - 1)
    rows = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))), H - 1)
    return img[rows.astype(np.int64)[:, None], cols.astype(np.int64)]


def resize_linear(x: torch.Tensor, img_wh: tuple[int, int]) -> torch.Tensor:
    """(H, W) or (H, W, C) float resized to (w, h) with OpenCV's
    ``INTER_LINEAR`` semantics, on ``x``'s device."""
    w, h = img_wh
    chw = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(h, w), mode="bilinear",
                        align_corners=False)[0]
    return out[0] if x.ndim == 2 else out.permute(1, 2, 0)


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.25, contrast: float = 0.5
                 ) -> np.ndarray:
    """Brightness/contrast jitter with torchvision ColorJitter semantics:
    factors drawn uniformly from [1-b, 1+b] / [1-c, 1+c], random order."""
    img = img.astype(np.float32)
    ops = [0, 1]
    rng.shuffle(ops)
    for op in ops:
        if op == 0:
            f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
            img = img * f
        else:
            f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
            mean = img.mean(axis=(0, 1), keepdims=True).mean(axis=-1,
                                                             keepdims=True)
            img = (img - mean) * f + mean
    return np.clip(img, 0, 255).astype(np.uint8)


def depth_pyramid(depth_0: np.ndarray, levels: int = 3
                  ) -> dict[str, np.ndarray]:
    """Nearest-neighbour half-resolution pyramid {'level_0': full, ...}."""
    out = {"level_0": depth_0.astype(np.float32)}
    for l in range(1, levels):
        out[f"level_{l}"] = out[f"level_{l - 1}"][::2, ::2].copy()
    return out


def mask_pyramid(mask_0: np.ndarray, levels: int = 3
                 ) -> dict[str, np.ndarray]:
    """Nearest-neighbour boolean mask pyramid."""
    out = {"level_0": mask_0.astype(bool)}
    for l in range(1, levels):
        out[f"level_{l}"] = out[f"level_{l - 1}"][::2, ::2].copy()
    return out
