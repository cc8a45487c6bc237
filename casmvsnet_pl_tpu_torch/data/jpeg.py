"""JPEG decoding and encoding without PIL or OpenCV.

The port reads the JPEG datasets (BlendedMVS, Tanks and Temples) through
``data/base.py``: ``load_image`` gives the pixels of PIL's
``Image.open(path).convert("RGB")``, and ``load_image_cv2`` (fusion's
colours) those of ``cv2.imread(path)[..., ::-1]``. :func:`decode_jpeg`
reproduces libjpeg(-turbo)'s default decompression to the bit and returns
the file's EXIF orientation, which :func:`orient` applies as
``cv2.imread`` does (PIL's ``Image.open`` ignores it).

Decoded: 8-bit baseline and extended sequential (SOF0, SOF1) and
progressive (SOF2) Huffman-coded files with one (grey) or three (YCbCr, or
RGB as libjpeg detects it) components, any integer sampling factors,
restart intervals. Refused with ``ValueError``: arithmetic coding,
lossless and hierarchical files, 12-bit samples, CMYK/YCCK (four
components), progressive files whose low-frequency coefficients are left
unrefined (libjpeg would smooth their blocks), and the malformed headers
libjpeg refuses (marker lengths, scans of 0 or more than 4 components or
naming one twice, progressive scan parameters out of range).

:func:`encode_jpeg` writes what ``cv2.imwrite(path, bgr)`` writes at
OpenCV's defaults (quality 95, 4:2:0, standard Huffman tables) for an RGB
or grey image, and optionally 4:4:4 sampling, a restart interval, or
libjpeg's default progressive scan script with optimal Huffman tables.
The entropy coding, transforms, upsampling and colour conversion are C (``jpeg_native.c``, built at first use like
``image_native.c``; if it cannot be built, decoding raises); the markers
are parsed here.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from .native import build_library

SOI, EOI, SOS, DQT, DHT, DRI = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
_SIGNATURE = b"\xff\xd8\xff"
# zigzag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)",
    0xC7: "differential lossless (hierarchical)",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}


@functools.cache
def jpeg_lib() -> ctypes.CDLL:
    """The compiled ``jpeg_native.c`` with its argument types declared."""
    lib = build_library("jpeg_native")
    ptr = ctypes.c_void_p
    n = ctypes.c_int64
    lib.jpeg_decode_scan.argtypes = [ptr, n, n, ptr, ptr, ptr, n]
    lib.jpeg_decode_scan.restype = n
    lib.jpeg_idct_plane.argtypes = [ptr, n, n, n, ptr, ptr]
    lib.jpeg_idct_plane.restype = None
    lib.jpeg_upsample.argtypes = [ptr, n, n, n, n, n, ptr, n, n]
    lib.jpeg_upsample.restype = None
    lib.jpeg_ycc_rgb.argtypes = [ptr, ptr, ptr, ptr, n]
    lib.jpeg_ycc_rgb.restype = None
    lib.jpeg_rgb_ycc.argtypes = [ptr, ptr, ptr, ptr, n]
    lib.jpeg_rgb_ycc.restype = None
    lib.jpeg_fdct_plane.argtypes = [ptr, n, n, ptr, ptr, n]
    lib.jpeg_fdct_plane.restype = None
    lib.jpeg_encode_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, n]
    lib.jpeg_encode_scan.restype = n
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    """One frame component and its grid of coefficient blocks."""

    def __init__(self, cid, h, v, tq, width, height, max_h, max_v):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.width = _ceil_div(width * h, max_h)          # samples
        self.height = _ceil_div(height * v, max_v)
        self.wb = _ceil_div(self.width, 8)                # real blocks
        self.hb = _ceil_div(self.height, 8)
        self.stride = _ceil_div(width, 8 * max_h) * h     # MCU-padded grid
        self.rows = _ceil_div(height, 8 * max_v) * v
        self.offset = 0
        self.qtable = None
        # successive-approximation state of each zigzag coefficient
        # (-1: not seen), as libjpeg's coef_bits
        self.coef_bits = np.full(64, -1)


def _scan_params(comps, scan_comps, ss, se, ah, al, interval, frame,
                 progressive) -> np.ndarray:
    """The int64 scan description ``jpeg_native.c`` reads."""
    width, height, max_h, max_v = frame
    if len(scan_comps) == 1:
        c = comps[scan_comps[0][0]]
        mcus = (c.wb, c.hb)
    else:
        mcus = (_ceil_div(width, 8 * max_h), _ceil_div(height, 8 * max_v))
    head = [len(scan_comps), ss, se, ah, al, interval, mcus[0], mcus[1],
            int(progressive)]
    for ci, td, ta in scan_comps:
        c = comps[ci]
        head += [c.offset, c.stride, c.wb, c.hb, c.h, c.v, td, ta]
    return np.array(head, np.int64)


def _scan_header(body: bytes, comps, what: str):
    """An SOS body -> ([(component index, DC table, AC table)], Ss, Se,
    Ah, Al), refused as libjpeg's ``get_sos`` refuses it: a length other
    than 2 Ns + 4, Ns outside 1..4 (``MAX_COMPS_IN_SCAN``), a component
    the frame lacks or named twice, and an interleaved scan of more than
    10 blocks an MCU (``D_MAX_BLOCKS_IN_MCU``)."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 2 * ns + 4:
        raise ValueError(f"{what}: bad scan header ({ns} components in "
                         f"{len(body)} bytes)")
    scan_comps = []
    for k in range(ns):
        cid, tables = body[1 + 2 * k], body[2 + 2 * k]
        ci = next((j for j, c in enumerate(comps) if c.cid == cid), None)
        if ci is None:
            raise ValueError(f"{what}: scan names unknown component {cid}")
        if any(ci == s[0] for s in scan_comps):
            raise ValueError(f"{what}: scan names component {cid} twice")
        scan_comps.append((ci, tables >> 4, tables & 15))
    if ns > 1 and sum(comps[ci].h * comps[ci].v
                      for ci, _, _ in scan_comps) > 10:
        raise ValueError(f"{what}: sampling factors too large for an "
                         "interleaved scan")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    return scan_comps, ss, se, a >> 4, a & 15


def _check_progression(ns: int, ss: int, se: int, ah: int, al: int,
                       what: str) -> None:
    """Refuse a progressive scan's parameters as libjpeg's
    ``start_pass_phuff_decoder`` does (``JERR_BAD_PROGRESSION``)."""
    if ss == 0:
        bad = se != 0                         # a DC scan
    else:                                     # an AC scan: one component
        bad = ss > se or se > 63 or ns != 1
    if ah != 0 and al != ah - 1:
        bad = True
    if bad or al > 13:
        raise ValueError(f"{what}: invalid progressive scan Ss={ss} "
                         f"Se={se} Ah={ah} Al={al} ({ns} components)")


def _parse_exif_orientation(body: bytes) -> int:
    """Orientation (1-8) from an APP1 Exif payload, 1 when absent."""
    tiff = body[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    ifd, = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    count, = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(end + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:
            value, = struct.unpack(end + "H", entry[8:10])
            return value if 1 <= value <= 8 else 1
    return 1


def decode_jpeg(data: bytes, what: str = "JPEG"):
    """JPEG bytes -> (pixels, EXIF orientation): pixels uint8 (H, W) for
    grey or (H, W, 3) RGB, as libjpeg decodes them by default."""
    if data[:3] != _SIGNATURE:
        raise ValueError(f"{what}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    lib = jpeg_lib()
    qtables: dict[int, np.ndarray] = {}
    huff = np.zeros((8, 272), np.int32)
    present = 0
    comps: list[_Component] = []
    frame = None
    coefs = None
    progressive = False
    interval = 0
    jfif = adobe = False
    adobe_transform = None
    orientation = 1
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                                 # garbage before a marker
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{what}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == EOI:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                                 # stray RSTn / TEM
        if pos + 2 > len(data):
            raise ValueError(f"{what}: truncated JPEG")
        length, = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError(f"{what}: truncated marker 0x{marker:02X}")
        pos += length
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and \
                orientation == 1:
            orientation = _parse_exif_orientation(body)
        elif marker == DQT:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                if tq > 3 or pq > 1 or i + 1 + n > len(body):
                    raise ValueError(f"{what}: bad quantisation table")
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[ZIGZAG] = vals
                qtables[tq] = table
                i += 1 + n
        elif marker == DHT:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(bits.sum())
                if tc > 1 or th > 3 or n > 256 or len(bits) < 16 or \
                        i + 17 + n > len(body):
                    raise ValueError(f"{what}: bad Huffman table")
                t = 4 * tc + th
                huff[t] = 0
                huff[t, :16] = bits
                huff[t, 16:16 + n] = np.frombuffer(body[i + 17:i + 17 + n],
                                                   np.uint8)
                present |= 1 << t
                i += 17 + n
        elif marker == DRI:
            if len(body) != 2:
                raise ValueError(f"{what}: bad restart interval marker")
            interval, = struct.unpack(">H", body)
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{what}: more than one frame header")
            if len(body) < 6 or len(body) != 6 + 3 * body[5]:
                raise ValueError(f"{what}: bad frame header")
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{what}: {precision}-bit JPEG; only 8-bit "
                                 "samples are supported")
            if width == 0 or n == 0:
                raise ValueError(f"{what}: empty image")
            if height == 0:
                raise ValueError(f"{what}: JPEG height given by a DNL "
                                 "marker is not supported")
            if n not in (1, 3):
                kind = "CMYK/YCCK" if n == 4 else f"{n}-component"
                raise ValueError(f"{what}: {kind} JPEG is not supported")
            raw = [body[6 + 3 * k:9 + 3 * k] for k in range(n)]
            max_h = max(c[1] >> 4 for c in raw)
            max_v = max(c[1] & 15 for c in raw)
            for cid, hv, tq in raw:
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or max_h % h or \
                        max_v % v:
                    raise ValueError(f"{what}: unsupported sampling "
                                     f"factors {h}x{v} of {max_h}x{max_v}")
                comps.append(_Component(cid, h, v, tq, width, height,
                                        max_h, max_v))
            total = 0
            for c in comps:
                c.offset = total
                total += c.rows * c.stride * 64
            coefs = np.zeros(total, np.int16)
            frame = (width, height, max_h, max_v)
            progressive = marker == 0xC2
        elif marker in _UNSUPPORTED_SOF or marker == 0xCC:
            kind = _UNSUPPORTED_SOF.get(marker, "arithmetic-coded")
            raise ValueError(f"{what}: {kind} JPEG is not supported")
        elif marker == 0xDC:
            raise ValueError(f"{what}: DNL marker is not supported")
        elif marker == SOS:
            if frame is None:
                raise ValueError(f"{what}: SOS before SOF")
            scan_comps, ss, se, ah, al = _scan_header(body, comps, what)
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            else:
                _check_progression(len(scan_comps), ss, se, ah, al, what)
            for k, (ci, td, ta) in enumerate(scan_comps):
                need_dc, need_ac = (ss == 0 and ah == 0), se > 0
                need = ([td] if need_dc else []) + ([4 + ta] if need_ac
                                                    else [])
                if td > 3 and need_dc or ta > 3 and need_ac or any(
                        not present >> t & 1 for t in need):
                    raise ValueError(f"{what}: scan uses an undefined "
                                     "Huffman table")
                # a table the scan does not decode with is never looked up
                scan_comps[k] = (ci, td if need_dc else 0,
                                 ta if need_ac else 0)
            for ci, _, _ in scan_comps:
                c = comps[ci]
                if c.qtable is None:               # latched at first scan
                    if c.tq not in qtables:
                        raise ValueError(f"{what}: component {c.cid} uses "
                                         f"undefined table {c.tq}")
                    c.qtable = qtables[c.tq].copy()
                c.coef_bits[ss:se + 1] = al
            params = _scan_params(comps, scan_comps, ss, se, ah, al,
                                  interval, frame, progressive)
            end = lib.jpeg_decode_scan(_p(buf), len(data), pos, _p(params),
                                       _p(coefs), _p(huff), present)
            if end == -1:
                raise ValueError(f"{what}: missing restart marker")
            if end == -2:
                raise ValueError(f"{what}: bad Huffman table")
            if end == -3:
                raise MemoryError(f"{what}: no memory for Huffman tables")
            if end < 0:
                raise ValueError(f"{what}: bad scan header")
            pos = int(end)
    if frame is None:
        raise ValueError(f"{what}: no frame header")
    if progressive:
        for c in comps:
            if c.coef_bits[0] >= 0 and (c.coef_bits[1:10] != 0).any():
                raise ValueError(
                    f"{what}: progressive JPEG with unrefined low-frequency "
                    "coefficients (libjpeg would smooth its blocks) is not "
                    "supported")
    width, height, max_h, max_v = frame
    planes = []
    for c in comps:
        if c.qtable is None:
            raise ValueError(f"{what}: component {c.cid} has no scan")
        plane = np.empty((c.hb * 8, c.wb * 8), np.uint8)
        lib.jpeg_idct_plane(_p(coefs[c.offset:]), c.stride, c.hb, c.wb,
                            _p(c.qtable), _p(plane))
        full = np.empty((height, width), np.uint8)
        lib.jpeg_upsample(_p(plane), c.wb * 8, c.width, c.height,
                          max_h // c.h, max_v // c.v, _p(full), width,
                          height)
        planes.append(full)
    if len(comps) == 1:
        return planes[0], orientation
    ids = tuple(c.cid for c in comps)
    if jfif:
        rgb_space = False
    elif adobe:
        rgb_space = adobe_transform == 0
    else:
        rgb_space = ids == (82, 71, 66)
    if rgb_space:
        return np.stack(planes, axis=-1), orientation
    out = np.empty((height, width, 3), np.uint8)
    lib.jpeg_ycc_rgb(_p(planes[0]), _p(planes[1]), _p(planes[2]), _p(out),
                     width * height)
    return out, orientation


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn ``img`` (H, W[, C]) as EXIF ``orientation`` says, as OpenCV's
    ``imread`` does (``ExifTransform``)."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flip.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def is_jpeg(data: bytes) -> bool:
    return data[:3] == _SIGNATURE


# ------------------------------------------------------------------ encoder

# Annex K tables: quantisation in natural order, Huffman (bits, values)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
# luma's sampling factors (h, v) for each chroma subsampling
SUBSAMPLING = {"4:2:0": (2, 2), "4:4:4": (1, 1)}
QUALITY = 95                    # cv2.imwrite's default


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``: the
    standard tables scaled by ``jpeg_quality_scaling``."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    out = []
    for base in (STD_LUMA_Q, STD_CHROMA_Q):
        t = (base * scale + 50) // 100
        out.append(np.clip(t, 1, 255).astype(np.uint16))
    return out[0], out[1]


def _huffman_codes(bits, vals) -> np.ndarray:
    """(256, 2) int32 (code, size) of each symbol (Annex C)."""
    table = np.zeros((256, 2), np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def optimal_huffman(freq: np.ndarray):
    """``jpeg_gen_optimal_table``: (bits, values) of an optimal length-16
    limited code for the symbol counts ``freq`` (256,)."""
    freq = [int(x) for x in freq[:256]] + [1]     # pseudo-symbol 256
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [j for length in range(1, 33) for j in range(256)
            if codesize[j] == length]
    return bits[1:17], vals


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _dht(tc: int, th: int, bits, vals) -> bytes:
    return _marker(DHT, bytes([tc << 4 | th]) + bytes(bits) + bytes(vals))


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to (rows, cols)."""
    return np.pad(plane, ((0, rows - plane.shape[0]),
                          (0, cols - plane.shape[1])), mode="edge")


def _downsample(plane: np.ndarray, h: int, v: int, comp: _Component
                ) -> np.ndarray:
    """A full-size plane at the chroma component's sampling, as jcsample.c
    (h2v2 with alternating bias; box averages otherwise), padded to its
    real blocks as jcprepct.c pads (replicated rows and columns)."""
    out_cols = comp.wb * 8
    full = _pad(plane, _ceil_div(plane.shape[0], v) * v, out_cols * h)
    x = full.astype(np.int32)
    if (h, v) == (2, 2):
        bias = np.tile([1, 2], out_cols)[:out_cols]
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        small = (s + bias) >> 2
    else:
        n = h * v
        s = x.reshape(x.shape[0] // v, v, out_cols, h).sum(axis=(1, 3))
        small = (s + n // 2) // n
    return _pad(small.astype(np.uint8), comp.hb * 8, out_cols)


def _dummy_blocks(blocks: np.ndarray, comp: _Component) -> None:
    """Fill the blocks of the MCU grid past the image as libjpeg's
    compressor does: AC zero, DC copied from the last real block to the
    left, and in block rows below the image from the MCU's last block in
    the row above (jccoefct.c)."""
    grid = blocks.reshape(comp.rows, comp.stride, 64)
    if comp.stride > comp.wb:
        grid[:comp.hb, comp.wb:] = 0
        grid[:comp.hb, comp.wb:, 0] = grid[:comp.hb, comp.wb - 1:comp.wb, 0]
    for r in range(comp.hb, comp.rows):
        grid[r] = 0
        last = grid[r - 1, comp.h - 1::comp.h, 0]
        grid[r, :, 0] = np.repeat(last, comp.h)


def _progression(n_comps: int):
    """libjpeg's ``jpeg_simple_progression`` script: (components, Ss, Se,
    Ah, Al) a scan."""
    all_c = tuple(range(n_comps))
    if n_comps == 3:
        return [(all_c, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (all_c, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return [(all_c, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
            ((0,), 1, 63, 2, 1), (all_c, 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def encode_jpeg(img: np.ndarray, subsampling: str = "4:2:0",
                progressive: bool = False, restart_interval: int = 0
                ) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> JPEG bytes. At the defaults,
    the file ``cv2.imwrite`` writes for the same image (in BGR): baseline,
    quality 95, 4:2:0 (one component for grey), Annex K Huffman tables, a
    JFIF header. ``progressive`` writes libjpeg's default scan script with
    optimal Huffman tables a scan; ``restart_interval`` (MCUs) adds a DRI
    marker and RSTn markers."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 3:
        grey = False
    elif img.ndim == 2:
        grey = True
    else:
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    height, width = img.shape[:2]
    if not (0 < width < 65536 and 0 < height < 65536):
        raise ValueError(f"encode_jpeg: size {width}x{height} out of range")
    lib = jpeg_lib()
    luma_q, chroma_q = quality_tables(QUALITY)
    if grey:
        planes, factors = [img], [(1, 1)]
    else:
        n = width * height
        y, cb, cr = (np.empty((height, width), np.uint8) for _ in range(3))
        lib.jpeg_rgb_ycc(_p(img), _p(y), _p(cb), _p(cr), n)
        if subsampling not in SUBSAMPLING:
            raise ValueError(f"encode_jpeg: subsampling {subsampling!r} not "
                             f"in {sorted(SUBSAMPLING)}")
        planes, factors = [y, cb, cr], [SUBSAMPLING[subsampling], (1, 1),
                                        (1, 1)]
    max_h = max(f[0] for f in factors)
    max_v = max(f[1] for f in factors)
    comps = [_Component(k + 1, h, v, min(k, 1), width, height, max_h, max_v)
             for k, (h, v) in enumerate(factors)]
    total = 0
    for c in comps:
        c.offset = total
        total += c.rows * c.stride * 64
    coefs = np.zeros(total, np.int16)
    qt = [luma_q, chroma_q]
    for c, plane in zip(comps, planes):
        if (c.h, c.v) == (max_h, max_v):
            samples = _pad(plane, c.hb * 8, c.wb * 8)
        else:
            samples = _downsample(plane, max_h // c.h, max_v // c.v, c)
        samples = np.ascontiguousarray(samples)
        lib.jpeg_fdct_plane(_p(samples), c.hb, c.wb, _p(qt[c.tq]),
                            _p(coefs[c.offset:]), c.stride)
        if len(comps) > 1:
            _dummy_blocks(coefs[c.offset:c.offset + c.rows * c.stride * 64],
                          c)

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq in sorted({c.tq for c in comps}):
        out.append(_marker(DQT, bytes([tq]) + bytes(
            qt[tq][ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([c.cid, c.h << 4 | c.v, c.tq]) for c in comps)
    out.append(_marker(0xC2 if progressive else 0xC0, sof))
    frame = (width, height, max_h, max_v)
    std = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
    scans = (_progression(len(comps)) if progressive
             else [(tuple(range(len(comps))), 0, 63, 0, 0)])
    if restart_interval:
        dri = _marker(DRI, struct.pack(">H", restart_interval))
    for k, (cs, ss, se, ah, al) in enumerate(scans):
        scan_comps = [(ci, comps[ci].tq, comps[ci].tq) for ci in cs]
        params = _scan_params(comps, scan_comps, ss, se, ah, al,
                              restart_interval, frame, progressive)
        codes = np.zeros((8, 256, 2), np.int32)
        tables = []
        if progressive:
            freq = np.zeros((8, 257), np.int64)
            lib.jpeg_encode_scan(_p(params), _p(coefs), _p(codes), _p(freq),
                                 None, 0)
            for t in sorted({c[1] for c in scan_comps}):
                if ss == 0 and ah == 0:
                    tables.append((0, t, *optimal_huffman(freq[t])))
                if se:
                    tables.append((1, t, *optimal_huffman(freq[4 + t])))
        else:
            for t in sorted({c[1] for c in scan_comps}):
                tables += [(0, t, *std[t][0]), (1, t, *std[t][1])]
        for tc, th, bits, vals in tables:
            codes[4 * tc + th] = _huffman_codes(bits, list(vals))
            out.append(_dht(tc, th, bits, vals))
        if restart_interval and k == 0:
            out.append(dri)
        if progressive and ss == 0:
            sel = [(ci, t, 0) if ah == 0 else (ci, 0, 0)
                   for ci, t, _ in scan_comps]
        elif progressive:
            sel = [(ci, 0, t) for ci, _, t in scan_comps]
        else:
            sel = scan_comps
        sos = bytes([len(sel)]) + b"".join(
            bytes([comps[ci].cid, td << 4 | ta]) for ci, td, ta in sel)
        out.append(_marker(SOS, sos + bytes([ss, se, ah << 4 | al])))
        cap = coefs.size + 4096
        while True:                   # grow the buffer until the scan fits
            data = np.empty(cap, np.uint8)
            n = lib.jpeg_encode_scan(_p(params), _p(coefs), _p(codes), None,
                                     _p(data), cap)
            if n != -1:
                break
            cap *= 2
        if n < 0:
            raise RuntimeError(f"jpeg_encode_scan failed ({n})")
        out.append(data[:n].tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, **kw) -> None:
    """Write :func:`encode_jpeg` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, **kw))
