"""The port's BlendedMVS and Tanks and Temples readers against the JAX
package's, on trees from the port's writers (``write_blendedmvs_tree``,
``write_tanks_tree``), every sample read one after another (the train
split's jitter shares one RandomState per reader): images bit-equal
(jitter included), depths and masks equal, proj_mats within 1e-6
relative, init_depth_min and depth_interval equal."""
import numpy as np
import pytest

from casmvsnet_pl_tpu.data import BlendedMVSDataset as JaxBlendedMVS
from casmvsnet_pl_tpu.data import TanksDataset as JaxTanks
from casmvsnet_pl_tpu.data import dataset_dict as jax_dataset_dict
from casmvsnet_pl_tpu_torch.data import (BlendedMVSDataset, DTUDataset,
                                         TanksDataset, dataset_dict,
                                         write_blendedmvs_tree,
                                         write_tanks_tree)

BMVS_CAMS = 6
TANKS_CAMS = 5
CASES = ([("blendedmvs", s, i) for s in ("train", "val", "all")
          for i in range(BMVS_CAMS * (2 if s == "all" else 1))]
         + [("tanks", s, i) for s in ("intermediate", "advanced")
            for i in range(TANKS_CAMS)])


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """{(dataset, split): (port samples, JAX samples, port reader)}, each
    reader's samples read in order."""
    root = str(tmp_path_factory.mktemp("bmvs"))
    bmvs = write_blendedmvs_tree(root, n_cams=BMVS_CAMS, img_wh=(768, 576))
    tanks = str(tmp_path_factory.mktemp("tanks"))
    write_tanks_tree(tanks, n_cams=TANKS_CAMS, image_scale=0.1)
    write_tanks_tree(tanks, split="advanced", image_scans=("Auditorium",),
                     n_cams=TANKS_CAMS, image_scale=0.1, z0=5.0,
                     baseline=0.25)
    out = {}
    for split in ("train", "val", "all"):
        kw = dict(n_views=3, depth_interval=192.0, img_wh=(64, 64), seed=3)
        port, jax = BlendedMVSDataset(bmvs, split, **kw), \
            JaxBlendedMVS(bmvs, split, **kw)
        out["blendedmvs", split] = ([port[i] for i in range(len(port))],
                                    [jax[i] for i in range(len(jax))], port)
    for split, scan in (("intermediate", "Family"),
                        ("advanced", "Auditorium")):
        kw = dict(n_views=3, img_wh=(96, 64))
        port, jax = TanksDataset(tanks, split, **kw), JaxTanks(tanks, split,
                                                               **kw)
        idx = [i for i, m in enumerate(port.metas) if m[0] == scan]
        out["tanks", split] = ([port[i] for i in idx], [jax[i] for i in idx],
                               port)
    return out


@pytest.mark.parametrize("name,split,i", CASES,
                         ids=[f"{n}-{s}-{i}" for n, s, i in CASES])
def test_sample_equals_jax(samples, name, split, i):
    ours, theirs, _ = samples[name, split]
    assert len(ours) == len(theirs)
    got, want = ours[i], theirs[i]
    assert sorted(got) == sorted(want)
    assert got["scan_vid"] == tuple(want["scan_vid"])
    assert got["imgs"].dtype == want["imgs"].dtype == np.float32
    assert np.array_equal(got["imgs"], want["imgs"])
    np.testing.assert_allclose(got["proj_mats"], want["proj_mats"],
                               rtol=1e-6, atol=0)
    for key in ("init_depth_min", "depth_interval"):
        assert got[key] == want[key], key
    if name == "blendedmvs":
        for level in want["depths"]:
            assert np.array_equal(got["depths"][level],
                                  want["depths"][level]), level
            assert np.array_equal(got["masks"][level],
                                  want["masks"][level]), level
        assert got["masks"]["level_0"].any()


def test_train_split_is_jittered(samples):
    """The train split's images differ from the same views read without
    jitter (the val reader of the same tree reads other scenes; read
    the train scene through the 'all' split, which does not jitter)."""
    train, _, _ = samples["blendedmvs", "train"]
    every, _, _ = samples["blendedmvs", "all"]
    plain = {s["scan_vid"]: s["imgs"] for s in every}
    assert all(not np.array_equal(s["imgs"], plain[s["scan_vid"]])
               for s in train)


def test_blendedmvs_protocol(samples):
    """Scene scale 100 / the first camera's depth_min; the interval is
    (depth_max - depth_min) / the hypothesis count; the plane's depths
    inside the swept range."""
    ours, _, port = samples["blendedmvs", "val"]
    assert port.scale_factors == {"synth_val": pytest.approx(100.0 / 368.0)}
    for s in ours:
        d = s["depths"]["level_0"]
        assert s["init_depth_min"] == pytest.approx(100.0)
        assert s["depth_interval"] == pytest.approx(
            (d.max() - 100.0) / 192.0)
        assert 100.0 < d.min() and d.max() <= 100.0 + 192 * \
            s["depth_interval"] + 1e-3


def test_blendedmvs_skips_views_with_too_few_sources(tmp_path):
    """A reference view is kept when its pair.txt count of sources (3
    here) reaches n_views, as the JAX reader's ``n_valid < n_views``."""
    root = write_blendedmvs_tree(str(tmp_path), n_cams=4, img_wh=(64, 48))
    assert len(BlendedMVSDataset(root, "val", n_views=3)) == 4
    assert len(BlendedMVSDataset(root, "val", n_views=4)) == 0
    with pytest.raises(AssertionError, match="split"):
        BlendedMVSDataset(root, "test")


def test_tanks_protocol(samples):
    ours, _, port = samples["tanks", "intermediate"]
    assert len(port) == 8 * TANKS_CAMS
    assert all(s["depth_interval"] == np.float32(2.5e-3) for s in ours)
    assert all(s["init_depth_min"] == np.float32(0.8) for s in ours)


def test_dataset_dict_matches_jax():
    assert sorted(dataset_dict) == sorted(jax_dataset_dict) == [
        "blendedmvs", "dtu", "tanks"]
    assert dataset_dict["dtu"] is DTUDataset
    assert dataset_dict["tanks"] is TanksDataset
    assert dataset_dict["blendedmvs"] is BlendedMVSDataset
