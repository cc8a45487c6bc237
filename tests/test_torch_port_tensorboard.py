"""The port's TensorBoard event writer (``utils/tensorboard.py``) read back
by TensorBoard's own event loader, its CRCs against TensorBoard's CRC-32C,
and the panels' colour maps (``utils/visualization.py``) against the JAX
package's OpenCV ones, bit for bit."""
import io
import os

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_file_loader import \
    RawEventFileLoader
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub import pywrap_tensorflow as tb_crc

from casmvsnet_pl_tpu.utils import visualization as jax_vis
from casmvsnet_pl_tpu_torch.utils import tensorboard as tb
from casmvsnet_pl_tpu_torch.utils import visualization as vis


def _write(log_dir):
    rng = np.random.RandomState(0)
    panel = rng.rand(3, 24, 40).astype(np.float32)
    panel[:, 0, 0] = (-0.5, 1.5, 1.0)           # clipped, as tensorboardX
    w = tb.SummaryWriter(str(log_dir))
    w.add_scalar("train/loss", 1.25, 1)
    w.add_scalar("lr", 1e-3, 1)
    w.add_image("train/image_GT_pred_prob", panel, 1)
    w.add_scalar("val/acc_2mm", 0.5, 17)
    w.add_scalar("train/loss", -3.0, 2 ** 40)
    w.close()
    want = (panel.transpose(1, 2, 0) * 255.0).clip(0, 255).astype(np.uint8)
    return w.path, want


def test_tensorboard_reads_the_events(tmp_path):
    path, panel = _write(tmp_path)
    assert os.path.basename(path).startswith("events.out.tfevents.")
    events = [event_pb2.Event.FromString(raw) for raw in
              RawEventFileLoader(path).Load()]
    assert len(events) == 6
    assert events[0].file_version == "brain.Event:2"
    values = [(e.step, v) for e in events[1:] for v in e.summary.value]
    scalars = [(s, v.tag, v.simple_value) for s, v in values
               if v.WhichOneof("value") == "simple_value"]
    assert scalars == [(1, "train/loss", 1.25),
                       (1, "lr", np.float32(1e-3)),
                       (17, "val/acc_2mm", 0.5),
                       (2 ** 40, "train/loss", -3.0)]
    (step, image), = [(s, v) for s, v in values
                      if v.WhichOneof("value") == "image"]
    assert (step, image.tag) == (1, "train/image_GT_pred_prob")
    img = image.image
    assert (img.height, img.width, img.colorspace) == (24, 40, 3)
    decoded = np.asarray(Image.open(io.BytesIO(img.encoded_image_string)))
    np.testing.assert_array_equal(decoded, panel)
    assert tuple(decoded[0, 0]) == (0, 255, 255)


def test_port_reader_round_trip(tmp_path):
    path, panel = _write(tmp_path)
    events = tb.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert tb.scalars(events) == {
        "train/loss": [(1, 1.25), (2 ** 40, -3.0)],
        "lr": [(1, float(np.float32(1e-3)))], "val/acc_2mm": [(17, 0.5)]}
    (step, img), = tb.images(events)["train/image_GT_pred_prob"]
    assert step == 1
    np.testing.assert_array_equal(img, panel)


@pytest.mark.parametrize("data,want", [
    (b"", 0x0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E)])
def test_crc32c_known_values(data, want):
    """The iSCSI test vectors of RFC 3720 (B.4) and the check value."""
    assert tb.crc32c(data) == want


def test_crcs_match_tensorboards_and_are_checked(tmp_path):
    rng = np.random.RandomState(1)
    for n in (1, 7, 100, 4099):
        data = rng.bytes(n)
        assert tb.masked_crc32c(data) == tb_crc.masked_crc32c(data)
    path, _ = _write(tmp_path)
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    records = list(tb.read_records(path))
    assert len(records) == 6
    for data in records:        # every stored CRC is TensorBoard's
        at = blob.index(data)
        stored = int.from_bytes(blob[at + len(data):at + len(data) + 4],
                                "little")
        assert stored == tb_crc.masked_crc32c(bytes(data))
    for offset, what in ((3, "length CRC"), (len(blob) - 6, "data CRC")):
        bad = tmp_path / f"bad{offset}"
        broken = bytearray(blob)
        broken[offset] ^= 0x10
        bad.write_bytes(bytes(broken))
        with pytest.raises(ValueError, match=what):
            list(tb.read_records(str(bad)))


@pytest.mark.parametrize("cmap", ["jet", "bone"])
def test_colormap_tables_equal_opencv(cmap):
    x = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(vis.apply_colormap(x, cmap),
                                  jax_vis._apply_colormap(x, cmap))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_visualize_depth_and_prob_equal_the_jax_package(seed):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(37, 53) * 300 + 425).astype(np.float32)
    depth[rng.rand(37, 53) < 0.3] = 0           # masked pixels
    depth[0, 0] = np.nan
    prob = rng.rand(37, 53).astype(np.float32) * 1.2 - 0.1
    for got, want in ((vis.visualize_depth(depth),
                       jax_vis.visualize_depth(depth)),
                      (vis.visualize_prob(prob),
                       jax_vis.visualize_prob(prob))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
