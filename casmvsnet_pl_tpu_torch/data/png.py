"""PNG decoding and encoding with the standard library's ``zlib``.

The port reads DTU's PNGs without PIL or OpenCV. :func:`decode_png` takes
8-bit, non-interlaced PNGs of every colour type (grey, grey+alpha, RGB,
RGBA, palette) and raises ``ValueError`` naming anything else. Its pixels
equal PIL's. The row filters are undone by a small C function
(``image_native.c``, built at first use by ``native.py``; if it cannot be
built, decoding raises). :func:`encode_png` writes grey or RGB images with
the Sub filter and zlib level 1, for the synthetic trees of
``data/synthetic.py``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .native import image_lib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
                 6: "RGBA"}


def _chunks(data: bytes, what: str):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{what}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{what}: truncated PNG (no IEND chunk)")


def decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """PNG bytes -> uint8 array: (H, W) grey, (H, W, 2) grey+alpha,
    (H, W, 3) RGB or palette (expanded), (H, W, 4) RGBA."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, what):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{what}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{what}: unknown PNG colour type {colour}")
    if depth != 8:
        raise ValueError(f"{what}: {depth}-bit {_COLOUR_NAMES[colour]} PNG; "
                         "only 8-bit samples are supported")
    if interlace != 0:
        raise ValueError(f"{what}: interlaced (Adam7) PNG is not supported")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{what}: unknown compression {compression} or "
                         f"filter method {filtering}")
    if colour == 3 and palette is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{what}: image data too short for "
                         f"{width}x{height} {_COLOUR_NAMES[colour]}")
    out = np.empty((height, stride), np.uint8)
    bad = image_lib().png_unfilter(
        np.ascontiguousarray(raw[:height * (stride + 1)]), out, height,
        stride, bpp)
    if bad:
        raise ValueError(f"{what}: unknown row filter type in row {bad - 1}")
    if colour == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[out]
    return out.reshape(height, width) if bpp == 1 else \
        out.reshape(height, width, bpp)


def read_png(path: str) -> np.ndarray:
    """:func:`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as (H, W, 3) RGB, as PIL's ``convert("RGB")``: grey is
    repeated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def to_grey(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as (H, W) grey, as OpenCV's ``imread(path, 0)``: alpha
    dropped, colour weighted by libpng's fixed-point 0.299 / 0.587 / 0.114
    (truncated), which that reader uses."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.int32)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2])
            >> 15).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes, every row Sub
    filtered, zlib level 1."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        colour, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        colour, bpp = 2, 3
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    height, width = img.shape[:2]
    rows = img.reshape(height, width * bpp)
    filtered = np.empty((height, width * bpp + 1), np.uint8)
    filtered[:, 0] = 1                                       # Sub
    filtered[:, 1:bpp + 1] = rows[:, :bpp]
    np.subtract(rows[:, bpp:], rows[:, :-bpp], out=filtered[:, bpp + 1:])
    ihdr = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
