"""``train_torch.py --dataset_name blendedmvs`` on the CPU: one epoch on
a synthetic BlendedMVS tree (one train and one val scene of 6 cameras,
JPEGs at the native 768x576, the reader at 64x64, batch 2, n_depths
8/8/8, f32, one loader thread), its train batches against the JAX
package's loader over the JAX reader as ``train.py`` builds them (jitter
included: one thread reads the samples in order), a finite loss, a
checkpoint; and the warm start from a checkpoint of another dataset."""
import os

import numpy as np
import pytest
import torch

import train_torch
from casmvsnet_pl_tpu.data import BlendedMVSDataset as JaxBlendedMVS
from casmvsnet_pl_tpu.data.loader import DataLoader as JaxLoader
from casmvsnet_pl_tpu_torch import opt as port_opt
from casmvsnet_pl_tpu_torch.data import (BlendedMVSDataset,
                                         write_blendedmvs_tree)
from casmvsnet_pl_tpu_torch.engine import MVSTrainer
from casmvsnet_pl_tpu_torch.utils import load_checkpoint

IMG_WH = (64, 64)


class Small(BlendedMVSDataset):
    """The reader at 64x64 (train_torch.py takes the default size)."""

    def __init__(self, *args, img_wh=IMG_WH, **kw):
        super().__init__(*args, img_wh=img_wh, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_blendedmvs_tree(str(tmp_path_factory.mktemp("bmvs")),
                                 n_cams=6, img_wh=(768, 576))


def _opts(root, *flags):
    return port_opt.get_opts(
        ["--cpu", "--root_dir", root, "--dataset_name", "blendedmvs",
         "--depth_interval", "192", "--n_depths", "8", "8", "8",
         "--batch_size", "2", "--optimizer", "adam", "--lr", "1e-3",
         "--precision", "f32", "--num_workers", "1", *flags])


def test_epoch_batches_equal_the_jax_loaders(root, tmp_path, monkeypatch):
    seen = []
    step = MVSTrainer.train_step

    def recording(self, state, batch):
        seen.append({k: (v.cpu().numpy() if torch.is_tensor(v) else
                         {kk: vv.cpu().numpy() for kk, vv in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in batch.items()})
        return step(self, state, batch)

    monkeypatch.setattr(MVSTrainer, "train_step", recording)
    monkeypatch.chdir(tmp_path)
    hp = _opts(root, "--num_epochs", "1", "--exp_name", "b1")
    trainer, state = train_torch.main(hp, Small, time_steps=True)
    assert state.step == 3 and len(seen) == 3
    losses = [t["loss"] for t in trainer.step_times]
    assert all(np.isfinite(losses))
    assert "last.ckpt" in os.listdir("ckpts/b1")
    assert load_checkpoint("ckpts/b1/last.ckpt")["step"] == 3

    # the JAX package's train loader, as train.py builds it
    ds = JaxBlendedMVS(root, "train", n_views=hp.n_views, levels=hp.levels,
                       depth_interval=hp.depth_interval, img_wh=IMG_WH)
    want = list(JaxLoader(ds, hp.batch_size, shuffle=True, num_workers=1,
                          seed=hp.seed))
    assert len(want) == len(seen)
    for got, w in zip(seen, want):
        assert np.array_equal(got["imgs"], w["imgs"])
        np.testing.assert_allclose(got["proj_mats"], w["proj_mats"],
                                   rtol=1e-6, atol=0)
        for key in ("init_depth_min", "depth_interval"):
            assert np.array_equal(got[key], w[key]), key
        for key in ("depths", "masks"):
            for level in w[key]:
                assert np.array_equal(got[key][level], w[key][level]), key


def test_warm_start_from_another_checkpoint(root, tmp_path, monkeypatch):
    """--ckpt_path: every parameter is the checkpoint's (a DTU run's in
    the README's transfer path; here a BlendedMVS epoch's)."""
    monkeypatch.chdir(tmp_path)
    train_torch.main(_opts(root, "--num_epochs", "1", "--exp_name", "src"),
                     Small)
    ckpt = load_checkpoint("ckpts/src/last.ckpt")
    _, state = train_torch.main(_opts(
        root, "--num_epochs", "0", "--exp_name", "warm", "--seed", "7",
        "--ckpt_path", "ckpts/src/last.ckpt"), Small)
    params = dict(state.model.named_parameters())
    assert sorted(params) == sorted(ckpt["params"])
    for k, v in ckpt["params"].items():
        assert torch.equal(params[k].detach(), v), k


def test_dataset_class_is_the_readers():
    assert train_torch.dataset_class("blendedmvs") is BlendedMVSDataset
