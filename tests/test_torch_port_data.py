"""The port's data modules against the JAX package's and against the PIL and
OpenCV calls those make: PNG decoding (bit-equal to PIL), PIL's bilinear
resize (bit-equal; the tolerance asked of it is 1 uint8 level), OpenCV's
nearest resizes (bit-equal), PFM and cam files, and the DTU reader and
synthetic tree writer in both directions (every key of every sample
equal; images within 1/255/std where a resize runs)."""
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from casmvsnet_pl_tpu.data import DTUDataset as JaxDTU
from casmvsnet_pl_tpu.data import cams as jax_cams
from casmvsnet_pl_tpu.data import read_pfm as jax_read_pfm
from casmvsnet_pl_tpu.data import save_pfm as jax_save_pfm
from casmvsnet_pl_tpu.data.base import IMAGENET_STD
from casmvsnet_pl_tpu.data.synthetic import PlaneScene as JaxScene
from casmvsnet_pl_tpu.data.synthetic import write_dtu_tree as jax_write_tree
from casmvsnet_pl_tpu_torch.data import (DTUDataset, PlaneScene, read_pfm,
                                         save_pfm, write_dtu_tree)
from casmvsnet_pl_tpu_torch.data import cams, png
from casmvsnet_pl_tpu_torch.data.base import (depth_pyramid, load_image,
                                              mask_pyramid, resize_nearest)

RESIZE_TOL = 1.0 / 255.0 / IMAGENET_STD.min()      # 1 uint8 level, normalized


def _smooth(rng, h, w, c):
    """A smooth uint8 image, (h, w) or (h, w, c)."""
    base = rng.rand(max(h // 8, 2), max(w // 8, 2), c).astype(np.float32)
    big = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    big = np.clip(big, 0, 1) * 255
    return big.astype(np.uint8).reshape(h, w, c) if c > 1 else \
        big.astype(np.uint8).reshape(h, w)


def _filter_types(data: bytes, stride: int) -> set:
    idat = b"".join(body for kind, body in png._chunks(data, "x")
                    if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw[::stride + 1].tolist())


@pytest.mark.parametrize("kind,wh", [("rgb", (1600, 1200)),
                                     ("grey", (333, 211)),
                                     ("rgb_noise", (64, 48))])
def test_png_decode_equals_pil_on_opencv_files(tmp_path, kind, wh):
    rng = np.random.RandomState(len(kind))
    w, h = wh
    if kind == "rgb_noise":
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        img = _smooth(rng, h, w, 1 if kind == "grey" else 3)
    path = str(tmp_path / "x.png")
    # a compression level turns on libpng's adaptive filters
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind == "rgb":                       # Sub and Paeth rows
        data = open(path, "rb").read()
        assert {1, 4} <= _filter_types(data, w * 3)


def _reference_filter(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """PNG filter ``ftype`` of every row (specification, section 9), in
    plain Python integers."""
    h, stride = rows.shape
    out = np.zeros((h, stride + 1), np.uint8)
    r = rows.astype(np.int64)
    for y in range(h):
        out[y, 0] = ftype
        for i in range(stride):
            a = r[y, i - bpp] if i >= bpp else 0
            b = r[y - 1, i] if y else 0
            c = r[y - 1, i - bpp] if (y and i >= bpp) else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i + 1] = (r[y, i] - pred) % 256
    return out


def _png_bytes(header, filtered, extra=(), idat=None) -> bytes:
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", *header)), *extra,
              (b"IDAT", idat if idat is not None
               else zlib.compress(filtered.tobytes())), (b"IEND", b"")]
    return png._SIGNATURE + b"".join(png._chunk(k, b) for k, b in chunks)


@pytest.mark.parametrize("colour", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decode_each_filter_and_colour_type(colour, ftype):
    rng = np.random.RandomState(10 * colour + ftype)
    w, h, bpp = 13, 7, png._CHANNELS[colour]
    if colour == 3:
        pal = rng.randint(0, 256, (37, 3)).astype(np.uint8)
        pixels = rng.randint(0, 37, (h, w)).astype(np.uint8)
        extra = [(b"PLTE", pal.tobytes())]
    else:
        pixels = rng.randint(0, 256, (h, w * bpp)).astype(np.uint8)
        extra = []
    data = _png_bytes((w, h, 8, colour, 0, 0, 0),
                      _reference_filter(pixels.reshape(h, -1), bpp, ftype),
                      extra)
    got = png.decode_png(data)
    pil = Image.open(io.BytesIO(data))
    want = np.asarray(pil.convert("RGB") if colour == 3 else pil)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.to_rgb(got),
                                  np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("case,match", [
    ("16bit", "16-bit"), ("interlaced", "interlaced"), ("crc", "corrupt"),
    ("filter", "row filter type")])
def test_png_rejects_what_it_does_not_take(case, match):
    rows = np.zeros((4, 1 + 4 * 3), np.uint8)
    header = [4, 4, 8, 2, 0, 0, 0]
    if case == "16bit":
        header[2] = 16
    if case == "interlaced":
        header[6] = 1
    if case == "filter":
        rows[2, 0] = 7
    data = _png_bytes(header, rows)
    if case == "crc":
        data = data[:40] + bytes([data[40] ^ 1]) + data[41:]
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
def test_png_encode_reads_back_in_pil_and_opencv(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "e.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if img.ndim == 2 else back[..., ::-1],
                                  img)


def test_png_grey_of_colour_equals_opencv(tmp_path):
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, np.random.RandomState(2).randint(
        0, 256, (64, 80, 3)).astype(np.uint8))
    np.testing.assert_array_equal(png.to_grey(png.read_png(path)),
                                  cv2.imread(path, 0))


@pytest.mark.parametrize("src_wh,dst_wh", [((1600, 1200), (1152, 864)),
                                           ((128, 96), (64, 48)),
                                           ((100, 80), (224, 160))])
def test_load_image_resize_matches_pil_bilinear(tmp_path, src_wh, dst_wh):
    """Tolerance 1 uint8 level; measured: 0 pixels differ (bit-equal)."""
    w, h = src_wh
    img = _smooth(np.random.RandomState(w), h, w, 3)
    path = str(tmp_path / "r.png")
    cv2.imwrite(path, img[..., ::-1])
    got = load_image(path, dst_wh).astype(np.int32)
    want = np.asarray(Image.open(path).convert("RGB").resize(
        dst_wh, Image.BILINEAR)).astype(np.int32)
    assert got.shape == want.shape == (dst_wh[1], dst_wh[0], 3)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() == 0.0
    np.testing.assert_array_equal(load_image(path), img)


@pytest.mark.parametrize("src_wh,dst_wh", [((1600, 1200), (1152, 864)),
                                           ((256, 256), (64, 64)),
                                           ((97, 45), (224, 160)),
                                           ((640, 512), (1600, 1184))])
def test_nearest_resizes_equal_opencv(src_wh, dst_wh):
    rng = np.random.RandomState(src_wh[0])
    depth = rng.rand(src_wh[1], src_wh[0]).astype(np.float32) * 500
    mask = (rng.rand(src_wh[1], src_wh[0]) > 0.5).astype(np.uint8) * 255
    for a in (depth, mask):
        np.testing.assert_array_equal(
            resize_nearest(a, dst_wh),
            cv2.resize(a, dst_wh, interpolation=cv2.INTER_NEAREST))
        half = cv2.resize(a, None, fx=0.5, fy=0.5,
                          interpolation=cv2.INTER_NEAREST)
        if a.shape[0] % 2 == 0 and a.shape[1] % 2 == 0:
            np.testing.assert_array_equal(a[::2, ::2], half)
    # the pyramids of a (512, 640) map, as DTU's training crop
    cur = rng.rand(512, 640).astype(np.float32) * 500
    mcur = (rng.rand(512, 640) > 0.5).astype(np.uint8)
    pyr, mpyr = depth_pyramid(cur), mask_pyramid(mcur > 0)
    for l in (1, 2):
        cur = cv2.resize(cur, None, fx=0.5, fy=0.5,
                         interpolation=cv2.INTER_NEAREST)
        mcur = cv2.resize(mcur, None, fx=0.5, fy=0.5,
                          interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(pyr[f"level_{l}"], cur)
        np.testing.assert_array_equal(mpyr[f"level_{l}"], mcur > 0)


@pytest.mark.parametrize("shape", [(7, 5), (6, 8, 3)])
def test_pfm_files_equal_jax(tmp_path, shape):
    data = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ours, theirs = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    save_pfm(ours, data)
    jax_save_pfm(theirs, data)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        got, scale = read_pfm(path)
        want, jscale = jax_read_pfm(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)
        assert scale == jscale == 1.0


def test_cams_equal_jax(tmp_path):
    root = str(tmp_path)
    jax_write_tree(root, scans=("s",), n_cams=4, img_wh=(64, 64),
                   native_wh=(128, 96))
    pairs = cams.read_pair_file(os.path.join(root, "Cameras/pair.txt"))
    assert pairs == jax_cams.read_pair_file(
        os.path.join(root, "Cameras/pair.txt"))
    mats = []
    for vid in range(4):
        path = os.path.join(root, f"Cameras/{vid:08d}_cam.txt")
        K, E, dmin = cams.read_cam_file(path)
        jK, jE, jdmin = jax_cams.read_cam_file(path)
        np.testing.assert_array_equal(K, jK)
        np.testing.assert_array_equal(E, jE)
        assert dmin == jdmin
        Ks = cams.scale_intrinsics_to_coarsest(K, (128, 96), (64, 32))
        np.testing.assert_array_equal(
            Ks, jax_cams.scale_intrinsics_to_coarsest(K, (128, 96), (64, 32)))
        m = cams.build_level_proj_mats(Ks, E)
        np.testing.assert_array_equal(m, jax_cams.build_level_proj_mats(Ks, E))
        mats.append(m)
    np.testing.assert_array_equal(
        cams.relative_proj_mats(mats[0], np.stack(mats[1:])),
        jax_cams.relative_proj_mats(mats[0], np.stack(mats[1:])))


def _tiny(base, lists):
    class Tiny(base):
        NATIVE_WH = (256, 256)
        DEPTH_CROP = ((32, 96), (32, 96))
        N_CAMS = 5
        LISTS_DIR = lists
    return Tiny


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree by each package's writer, and the split lists."""
    jax_root = str(tmp_path_factory.mktemp("jax_tree"))
    port_root = str(tmp_path_factory.mktemp("port_tree"))
    jax_write_tree(jax_root, scans=("synth1", "synth2"), n_cams=5)
    write_dtu_tree(port_root, scans=("synth1", "synth2"), n_cams=5)
    lists = str(tmp_path_factory.mktemp("lists"))
    for split, scan in (("train", "synth1"), ("val", "synth2"),
                        ("test", "synth1")):
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")
    return jax_root, port_root, lists


def _assert_samples_equal(got: dict, want: dict, img_tol: float) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if key == "scan_vid":
            assert tuple(g) == tuple(w)
        elif isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
        elif key == "imgs":
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.abs(g - w).max() <= img_tol
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("split,img_wh", [("train", None), ("val", None),
                                          ("test", (64, 64)),
                                          ("test", (32, 32))])
def test_dtu_reader_matches_jax(trees, writer, split, img_wh):
    """Each reader on each writer's tree: the same samples. The test split
    at 32x32 resizes the 64x64 images (PIL's filter on both sides)."""
    jax_root, port_root, lists = trees
    root = jax_root if writer == "jax" else port_root
    ours = _tiny(DTUDataset, lists)(root, split, n_views=3, img_wh=img_wh)
    theirs = _tiny(JaxDTU, lists)(root, split, n_views=3, img_wh=img_wh)
    assert ours.metas == theirs.metas and ours.scans == theirs.scans
    assert len(ours) == len(theirs) == (5 if split == "test" else 35)
    tol = 0.0 if img_wh in (None, (64, 64)) else RESIZE_TOL
    for i in sorted({0, len(ours) // 2 + 1, len(ours) - 1}):
        _assert_samples_equal(ours[i], theirs[i], tol)


def test_port_tree_geometry_equals_jax_tree(trees):
    """Same files, cameras, depths and masks; the images differ only by the
    texture's upsample (torch's bicubic, not OpenCV's)."""
    jax_root, port_root, _ = trees

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(port_root) == files(jax_root)
    for rel in files(jax_root):
        a, b = os.path.join(port_root, rel), os.path.join(jax_root, rel)
        if rel.endswith(".txt"):
            assert open(a).read() == open(b).read(), rel
        elif rel.endswith(".pfm"):
            np.testing.assert_array_equal(read_pfm(a)[0], read_pfm(b)[0])
        elif "depth_visual" in rel:
            np.testing.assert_array_equal(png.read_png(a),
                                          cv2.imread(b, cv2.IMREAD_UNCHANGED))
    kw = dict(img_wh=(64, 64), n_views=5, z0=460.0, slope_x=0.3)
    np.testing.assert_array_equal(PlaneScene(**kw).surface_points(3),
                                  JaxScene(**kw).surface_points(3))
    img = load_image(os.path.join(port_root,
                                  "Rectified/synth1/rect_001_3_r5000.png"))
    jimg = load_image(os.path.join(jax_root,
                                   "Rectified/synth1/rect_001_3_r5000.png"))
    assert np.abs(img.astype(int) - jimg).mean() < 4.0
