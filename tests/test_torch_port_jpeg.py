"""The port's JPEG codec (``data/jpeg.py``, ``data/jpeg_native.c``)
against the libraries the JAX package reads and writes JPEGs with: the
decoder against PIL's ``Image.open(p).convert("RGB")`` and against
``cv2.imread(p)[..., ::-1]`` (EXIF orientations included), the encoder
against ``cv2.imwrite``. Every comparison is to the bit."""
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from casmvsnet_pl_tpu_torch.data import native
from casmvsnet_pl_tpu_torch.data.base import load_image, load_image_cv2
from casmvsnet_pl_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from casmvsnet_pl_tpu_torch.data.png import write_png

SIZES = [(1, 1), (17, 9), (33, 31), (770, 577)]
QUALITIES = [50, 75, 95, 100]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _image(w: int, h: int, seed: int = 0, noise: int = 16) -> np.ndarray:
    """A colour ramp with noise: smooth parts and every frequency."""
    rng = np.random.RandomState(seed)
    ramp = (np.linspace(0, 1, w)[None, :, None]
            * np.linspace(0.3, 1, h)[:, None, None] * 230)
    img = ramp * np.array([1.0, 0.55, 0.2]) + rng.randint(0, noise,
                                                          (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("wh", SIZES, ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sub", SUBSAMPLING)
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_decoder_equals_pil(tmp_path, wh, quality, sub, progressive):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_image(*wh)).save(path, quality=quality,
                                      subsampling=SUBSAMPLING[sub],
                                      progressive=progressive)
    assert np.array_equal(load_image(path), _pil(path))


@pytest.mark.parametrize("options", [
    {"optimize": True}, {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1},
    {"optimize": True, "progressive": True, "restart_marker_blocks": 5},
    {"keep_rgb": True}, {"subsampling": 2, "restart_marker_rows": 2}],
    ids=["optimized-huffman", "restart-blocks", "restart-rows",
         "progressive-restart", "rgb-colour-space", "420-restart-rows"])
@pytest.mark.parametrize("wh", [(17, 9), (100, 77)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_decoder_equals_pil_on_options(tmp_path, options, wh):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_image(*wh, seed=1)).save(path, quality=90, **options)
    assert np.array_equal(load_image(path), _pil(path))


@pytest.mark.parametrize("wh", [(1, 1), (17, 9), (100, 77)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_decoder_equals_pil_on_grey(tmp_path, wh, progressive):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_image(*wh, seed=2)[..., 1]).save(
        path, quality=90, progressive=progressive)
    assert Image.open(path).mode == "L"
    got = load_image(path)
    assert got.shape == (wh[1], wh[0], 3)
    assert np.array_equal(got, _pil(path))


@pytest.mark.parametrize("wh", [(1, 1), (3, 3), (17, 9), (33, 31),
                                (770, 577)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("progressive,restart", [(False, 0), (False, 3),
                                                 (True, 0), (True, 3)],
                         ids=["baseline", "restart", "progressive",
                              "progressive-restart"])
def test_own_files_decode_as_pil(tmp_path, wh, sub, progressive, restart):
    """The encoder's own modes read back equal in PIL and in the port."""
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(encode_jpeg(_image(*wh, seed=3, noise=60),
                            subsampling=sub, progressive=progressive,
                            restart_interval=restart))
    assert np.array_equal(load_image(path), _pil(path))


@pytest.mark.parametrize("wh", [(1, 1), (3, 3), (17, 9), (33, 31),
                                (770, 577)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("progressive,restart", [(False, 0), (False, 3),
                                                 (True, 0), (True, 3)],
                         ids=["baseline", "restart", "progressive",
                              "progressive-restart"])
def test_h1v2_files_decode_as_pil(tmp_path, wh, progressive, restart):
    """4:4:0 (libjpeg's h1v2 fancy upsampling, which PIL cannot write),
    written by OpenCV, reads back equal in PIL and in the port."""
    path = str(tmp_path / "x.jpg")
    bgr = np.ascontiguousarray(_image(*wh, seed=3, noise=60)[..., ::-1])
    assert cv2.imwrite(path, bgr, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert _sampling_factors(open(path, "rb").read())[0] == (1, 2)
    assert np.array_equal(load_image(path), _pil(path))


@pytest.mark.parametrize("wh", [(1, 1), (17, 9), (100, 77), (770, 577)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_fusion_reader_equals_opencv(tmp_path, wh, progressive):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(_image(*wh, seed=4)).save(path, quality=80,
                                              progressive=progressive)
    assert np.array_equal(load_image_cv2(path),
                          cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_only_the_fusion_reader(tmp_path,
                                                       orientation):
    """cv2.imread turns the image as its EXIF orientation says; PIL's
    Image.open does not. The two readers keep both behaviours."""
    path = str(tmp_path / "x.jpg")
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(_image(33, 17, seed=5)).save(path, quality=90,
                                                 exif=exif.tobytes())
    assert np.array_equal(load_image_cv2(path),
                          cv2.imread(path)[..., ::-1])
    assert np.array_equal(load_image(path), _pil(path))


@pytest.mark.parametrize("wh", [(1, 1), (2, 2), (17, 9), (33, 31),
                                (100, 77), (770, 577)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
def test_encoder_equals_opencv(tmp_path, wh, grey):
    """encode_jpeg(rgb) decodes in PIL as cv2.imwrite(bgr)'s file does;
    the files are the same bytes."""
    img = _image(*wh, seed=6, noise=60)
    if grey:
        img = np.ascontiguousarray(img[..., 1])
    ref, ours = str(tmp_path / "cv2.jpg"), str(tmp_path / "port.jpg")
    cv2.imwrite(ref, img if grey else np.ascontiguousarray(img[..., ::-1]))
    with open(ours, "wb") as f:
        f.write(encode_jpeg(img))
    assert np.array_equal(_pil(ours), _pil(ref))
    with open(ref, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first
    SOS's data, and of each SOS with its entropy-coded data."""
    pos, out = 2, []
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


def _sampling_factors(data: bytes):
    """(h, v) of each component in the frame header."""
    for m, start, _ in _segments(data):
        if m in (0xC0, 0xC1, 0xC2):
            n = data[start + 9]
            return [(data[start + 11 + 3 * k] >> 4,
                     data[start + 11 + 3 * k] & 15) for k in range(n)]
    raise AssertionError("no frame header")


def _with_scan_header(data: bytes, k: int, body: list[int]) -> bytes:
    """``data`` with the header of its ``k``-th scan replaced by ``body``
    (the entropy-coded data kept)."""
    start = [s for s in _segments(data) if s[0] == 0xDA][k][1]
    length, = struct.unpack(">H", data[start + 2:start + 4])
    return (data[:start] + b"\xff\xda" + struct.pack(">H", len(body) + 2)
            + bytes(body) + data[start + 2 + length:])


# malformed scan headers libjpeg refuses, each (scan, header body): the
# baseline file's one scan is Y, Cb, Cr with tables 0/0, 1/1, 1/1; the
# progressive file's scans follow encode_jpeg's script (scan 1: Y AC 1-5
# at Al 2; scan 5: Y AC 1-63 refined from Ah 2 to Al 1)
BAD_SCANS = {
    "scan-of-5-components": (False, 0, [5] + [1, 0x00] * 5 + [0, 63, 0],
                             "bad scan header"),
    "scan-names-a-component-twice": (False, 0, [2, 1, 0x00, 1, 0x00, 0,
                                                63, 0], "twice"),
    "scan-header-length": (False, 0, [3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                      0, 0], "bad scan header"),
    "scan-huffman-table-index": (False, 0, [3, 1, 0x50, 2, 0x11, 3, 0x11,
                                            0, 63, 0], "undefined Huffman"),
    "progressive-se-past-63": (True, 1, [1, 1, 0x00, 1, 200, 0x02],
                               "invalid progressive"),
    "progressive-ss-after-se": (True, 1, [1, 1, 0x00, 9, 5, 0x02],
                                "invalid progressive"),
    "progressive-dc-scan-with-ac": (True, 0, [3, 1, 0x00, 2, 0x10, 3, 0x10,
                                              0, 5, 0x01],
                                    "invalid progressive"),
    "progressive-interleaved-ac": (True, 1, [2, 1, 0x00, 2, 0x00, 1, 5,
                                             0x02], "invalid progressive"),
    "progressive-al-past-13": (True, 1, [1, 1, 0x00, 1, 5, 0x0E],
                               "invalid progressive"),
    "progressive-refinement-skips-a-bit": (True, 5, [1, 1, 0x00, 1, 63,
                                                     0x20],
                                           "invalid progressive"),
}


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with byte ``offset`` of the first ``marker`` segment's
    body (after the length) set to ``value``."""
    for m, start, _ in _segments(data):
        if m == marker:
            i = start + 4 + offset
            return data[:i] + bytes([value]) + data[i + 1:]
    raise AssertionError(f"no marker 0x{marker:02X}")


@pytest.mark.parametrize("case,match", [
    ("not-jpeg", "not a JPEG"), ("arithmetic", "arithmetic"),
    ("lossless", "lossless"), ("12-bit", "12-bit"), ("cmyk", "CMYK"),
    ("unrefined-progressive", "unrefined"), ("truncated", "truncated"),
    ("restart-marker-length", "restart interval"),
    ("quantisation-table-index", "quantisation table"),
    ("frame-header-length", "bad frame header"),
    *((name, bad[-1]) for name, bad in BAD_SCANS.items())])
def test_decoder_refuses_what_it_does_not_take(tmp_path, case, match):
    base = encode_jpeg(_image(24, 16, seed=7))
    sof = 0xC0
    if case in BAD_SCANS:
        progressive, k, body, _ = BAD_SCANS[case]
        data = _with_scan_header(
            encode_jpeg(_image(24, 16, seed=7), progressive=progressive)
            if progressive else base, k, body)
        with pytest.raises(OSError):           # libjpeg refuses it too
            Image.open(io.BytesIO(data)).convert("RGB")
    elif case == "restart-marker-length":
        data = encode_jpeg(_image(24, 16, seed=7), restart_interval=2)
        i = data.index(b"\xff\xdd")
        data = data[:i + 2] + b"\x00\x05\x00\x02\x00" + data[i + 6:]
    elif case == "quantisation-table-index":
        data = _patched(base, 0xDB, 0, 0x05)
    elif case == "frame-header-length":
        data = _patched(base, sof, 5, 4)          # 4 components, 3 given
    elif case == "not-jpeg":
        path = str(tmp_path / "x.png")
        write_png(path, _image(8, 8))
        data = open(path, "rb").read()
    elif case == "arithmetic":
        data = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    elif case == "lossless":
        data = base.replace(b"\xff\xc0", b"\xff\xc3", 1)
    elif case == "12-bit":
        data = _patched(base, sof, 0, 12)
    elif case == "cmyk":
        path = str(tmp_path / "x.jpg")
        Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(path)
        data = open(path, "rb").read()
    elif case == "unrefined-progressive":
        # the first two scans of the default progression only: DC, and
        # luma AC 1-5 at Al=2 (libjpeg would smooth such blocks)
        prog = encode_jpeg(_image(24, 16, seed=7), progressive=True)
        scans = [s for s in _segments(prog) if s[0] == 0xDA]
        data = prog[:scans[1][2]] + b"\xff\xd9"
    else:
        data = base[:len(base) // 2]
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


@pytest.mark.parametrize("head", [
    [5, 1, 0, 0, 0, 0, 1, 1, 0], [1, 0, 200, 0, 0, 0, 1, 1, 1],
    [1, 9, 5, 0, 0, 0, 1, 1, 1], [1, 1, 5, 0, 14, 0, 1, 1, 1],
    [1, 0, 63, 0, 0, 0, 1, 1, 0]],
    ids=["5-components", "se-past-63", "ss-after-se", "al-past-13",
         "table-past-3"])
def test_native_scan_decoder_refuses_out_of_range_headers(head):
    """The C entry keeps to its buffers on its own: a scan description out
    of range returns -4 before any data is read."""
    from casmvsnet_pl_tpu_torch.data.jpeg import _p, jpeg_lib

    comp = [0, 1, 1, 1, 1, 1, 0, 5 if head[2] == 63 else 0]
    params = np.array(head + comp * min(head[0], 4), np.int64)
    data = np.zeros(16, np.uint8)
    coefs = np.zeros(64, np.int16)
    huff = np.zeros((8, 272), np.int32)
    assert jpeg_lib().jpeg_decode_scan(_p(data), 16, 0, _p(params),
                                       _p(coefs), _p(huff), 0) == -4


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a C source that does not compile raises."""
    (tmp_path / "broken.c").write_text("int f( {\n")
    monkeypatch.setattr(native, "_SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building broken.c failed"):
        native.build_library("broken")


@pytest.mark.parametrize("src_wh,dst_wh", [((768, 576), (768, 576)),
                                           ((768, 576), (64, 64)),
                                           ((1920, 1080), (1152, 864)),
                                           ((97, 61), (160, 96))])
def test_load_image_reads_jpeg_as_pil(tmp_path, src_wh, dst_wh):
    """load_image: a JPEG found by its signature (here behind a .png
    name), PIL's bilinear resize; the identity resize exact."""
    path = str(tmp_path / "x.png")
    Image.fromarray(_image(*src_wh, seed=8)).save(path, format="JPEG",
                                                  quality=95)
    want = np.asarray(Image.open(path).convert("RGB").resize(
        dst_wh, Image.BILINEAR))
    got = load_image(path, dst_wh)
    assert got.shape == (dst_wh[1], dst_wh[0], 3)
    assert np.array_equal(got, want)
    if src_wh == dst_wh:
        assert np.array_equal(got, _pil(path))


def test_write_jpeg_files_match_encode(tmp_path):
    from casmvsnet_pl_tpu_torch.data.jpeg import write_jpeg

    img = _image(40, 30, seed=9)
    path = str(tmp_path / "x.jpg")
    write_jpeg(path, img, subsampling="4:4:4")
    assert os.path.getsize(path) > 0
    with open(path, "rb") as f:
        assert f.read() == encode_jpeg(img, subsampling="4:4:4")


def _dc_only_jpeg(size: int, diff: int) -> bytes:
    """A grey baseline JPEG of (size, size) whose every block holds only a
    DC difference of ``diff`` (no 8-bit encoder writes such a file): a
    quantisation table of ones and one-symbol Huffman tables (DC category
    15 and the AC end-of-block, each coded ``0``). The running DC wraps
    through int16 and the IDCT's output leaves the sample range."""
    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    one_code = b"\x01" + b"\x00" * 15
    head = (b"\xff\xd8" + segment(0xDB, b"\x00" + b"\x01" * 64)
            + segment(0xC0, struct.pack(">BHHB", 8, size, size, 1)
                      + b"\x01\x11\x00")
            + segment(0xC4, b"\x00" + one_code + b"\x0f")
            + segment(0xC4, b"\x10" + one_code + b"\x00")
            + segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"))
    magnitude = diff if diff > 0 else diff - 1    # one's complement bits
    bits = ("0" + format(magnitude & 0x7FFF, "015b") + "0") * (size // 8) ** 2
    bits += "1" * (-len(bits) % 8)
    scan = int(bits, 2).to_bytes(len(bits) // 8, "big")
    return head + scan.replace(b"\xff", b"\xff\x00") + b"\xff\xd9"


@pytest.mark.parametrize("size,diff", [(2048, 32767), (256, -32767),
                                       (256, 20000)])
def test_out_of_range_idct_saturates_as_pil_and_opencv(tmp_path, size, diff):
    """The IDCT's output saturates, and a DC-only column's shifted DC wraps
    to 16 bits, as in the SIMD IDCT that PIL and OpenCV run: on the
    2048x2048 file with +32767 half the blocks leave [-384, 639], where
    libjpeg's C range table would wrap them."""
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(_dc_only_jpeg(size, diff))
    pil = _pil(path)
    assert np.array_equal(pil, cv2.imread(path)[..., ::-1])
    assert np.array_equal(load_image(path), pil)
    assert np.array_equal(load_image_cv2(path), pil)
