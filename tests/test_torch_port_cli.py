"""``train_torch.py``, the port's training CLI, on the CPU: its flags
against ``casmvsnet_pl_tpu.opt.get_opts``, one epoch on a synthetic DTU
tree (checkpoints and TensorBoard events), full resume bit for bit against
an uninterrupted run, warm start with ignored prefixes, and what it
refuses.

The tree: one train scan and one val scan, 3 cameras, 7 lights (21
samples a split), rectified PNGs at 32x32 and native depths at 128x128
written so that the train protocol's half-resize and crop line up with
the images (``write_dtu_tree(depth_crop=...)``); n_depths 8/8/8, global
batch 4 (5 train steps and 6 val batches an epoch); 32x32 keeps the
file within ~30 s.
"""
import argparse
import os
import subprocess
import sys

import pytest
import torch

import train_torch
from casmvsnet_pl_tpu import opt as jax_opt
from casmvsnet_pl_tpu_torch import opt as port_opt
from casmvsnet_pl_tpu_torch.data import DTUDataset, write_dtu_tree
from casmvsnet_pl_tpu_torch.utils import load_checkpoint
from casmvsnet_pl_tpu_torch.utils.tensorboard import (images, read_events,
                                                      scalars)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = ((16, 48), (16, 48))
# flags of the port that the JAX package does not have
PORT_ONLY = {"cpu", "arch"}


def _parser(module, monkeypatch):
    """The parser that ``module.get_opts`` builds."""
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, argv=None: self)
        return module.get_opts([])


def _actions(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("window", ["", "1"])
def test_flags_match_the_jax_package(monkeypatch, window):
    monkeypatch.setenv("CASMVS_ENABLE_WINDOW_SAMPLING", window)
    port = _actions(_parser(port_opt, monkeypatch))
    jax = _actions(_parser(jax_opt, monkeypatch))
    assert set(port) - set(jax) == PORT_ONLY
    assert set(jax) <= set(port)
    for dest, want in jax.items():
        got = port[dest]
        for attr in ("option_strings", "default", "choices", "type", "nargs",
                     "const", "required"):
            assert getattr(got, attr) == getattr(want, attr), (dest, attr)
        assert type(got) is type(want), dest
    assert ("window" in port["sampling"].choices) == (window == "1")
    assert port["num_devices"].option_strings == ["--num_devices",
                                                  "--num_gpus"]
    assert port["cpu"].default is False


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    write_dtu_tree(root, scans=("synth1", "synth2"), n_cams=3,
                   img_wh=(32, 32), native_wh=(128, 128), focal=50.0,
                   depth_crop=CROP)
    lists = os.path.join(root, "lists")
    os.makedirs(lists)
    for split, scan in (("train", "synth1"), ("val", "synth2")):
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")

    class Tiny(DTUDataset):
        NATIVE_WH = (128, 128)
        DEPTH_CROP = CROP
        N_CAMS = 3
        LISTS_DIR = lists
    return root, Tiny


def _opts(root, *flags):
    return port_opt.get_opts(
        ["--cpu", "--root_dir", root, "--n_depths", "8", "8", "8",
         "--batch_size", "4", "--optimizer", "adam", "--lr", "1e-3",
         "--precision", "f32", "--num_workers", "2", *flags])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: one summation order, so runs are
    bit-reproducible; and the tier-1 run puts several test processes on
    the host's cores, where more threads each slow these steps many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_epoch_writes_checkpoints_and_events(tree, tmp_path,
                                                 monkeypatch):
    root, Tiny = tree
    monkeypatch.chdir(tmp_path)
    trainer, state = train_torch.main(
        _opts(root, "--num_epochs", "1", "--exp_name", "e1"), Tiny,
        time_steps=True)
    assert state.step == 5
    losses = [t["loss"] for t in trainer.step_times]
    assert len(losses) == 5 and all(torch.isfinite(torch.tensor(losses)))
    files = sorted(os.listdir("ckpts/e1"))
    assert files == ["epoch=00.ckpt", "index.json", "last.ckpt"]
    ckpt = load_checkpoint("ckpts/e1/last.ckpt")
    assert ckpt["step"] == 5 and ckpt["opt_state"]["state"]
    (events,) = os.listdir("logs/e1")
    assert events.startswith("events.out.tfevents.")
    ev = read_events(os.path.join("logs/e1", events))
    tags = scalars(ev)
    assert {"train/loss", "train/abs_err", "train/acc_1mm", "train/acc_2mm",
            "train/acc_4mm", "lr", "val/loss", "val/abs_err", "val/acc_1mm",
            "val/acc_2mm", "val/acc_4mm"} == set(tags)
    assert tags["train/loss"] == [(1, pytest.approx(losses[0]))]
    assert [s for s, _ in tags["val/acc_2mm"]] == [5]
    panels = images(ev)
    assert sorted(panels) == ["train/image_GT_pred_prob",
                              "val/image_GT_pred_prob"]
    for (step, img), want in zip((panels["train/image_GT_pred_prob"][0],
                                  panels["val/image_GT_pred_prob"][0]),
                                 (1, 5)):
        assert step == want and img.shape == (32, 128, 3)


def test_resume_is_bit_exact(tree, tmp_path, monkeypatch):
    """Two epochs in one run against one epoch, then ``--resume_path
    last.ckpt`` for one more: the same step count, parameters, BatchNorm
    statistics and optimizer state, bit for bit."""
    root, Tiny = tree
    monkeypatch.chdir(tmp_path)
    _, whole = train_torch.main(
        _opts(root, "--num_epochs", "2", "--exp_name", "whole"), Tiny)
    train_torch.main(_opts(root, "--num_epochs", "1", "--exp_name", "cut"),
                     Tiny)
    _, resumed = train_torch.main(
        _opts(root, "--num_epochs", "1", "--exp_name", "cut",
              "--resume_path", "ckpts/cut/last.ckpt"), Tiny)
    assert resumed.step == whole.step == 10
    want, got = whole.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ow, og = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in ow["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(og["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    # the resumed epoch is numbered on
    assert sorted(os.listdir("ckpts/cut")) == [
        "epoch=00.ckpt", "epoch=01.ckpt", "index.json", "last.ckpt"]


def test_warm_start_ignores_prefixes(tree, tmp_path, monkeypatch, capsys):
    root, Tiny = tree
    monkeypatch.chdir(tmp_path)
    train_torch.main(_opts(root, "--num_epochs", "1", "--exp_name", "a"),
                     Tiny)
    ckpt = load_checkpoint("ckpts/a/last.ckpt")
    capsys.readouterr()
    trainer, state = train_torch.main(
        _opts(root, "--num_epochs", "0", "--exp_name", "b", "--seed", "1",
              "--ckpt_path", "ckpts/a/last.ckpt", "--prefixes_to_ignore",
              "cost_reg_0"), Tiny)
    out = capsys.readouterr().out
    ignored = [line[len("ignore "):] for line in out.splitlines()
               if line.startswith("ignore ")]
    assert ignored and sorted(ignored) == sorted(
        k for k in ckpt["params"] if k.startswith("cost_reg_0"))
    assert state.step == 0
    params = dict(state.model.named_parameters())
    fresh = train_torch.main(_opts(root, "--num_epochs", "0", "--exp_name",
                                   "c", "--seed", "1"), Tiny)[1]
    fresh = dict(fresh.model.named_parameters())
    for k, v in ckpt["params"].items():
        want = fresh[k] if k.startswith("cost_reg_0") else v
        assert torch.equal(params[k].detach(), want.detach()), k
    buffers = dict(state.model.named_buffers())
    for k, v in ckpt["batch_stats"].items():     # all of them, as in JAX
        assert torch.equal(buffers[k], v), k


def test_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = os.path.join(REPO, "train_torch.py")
    proc = subprocess.run([sys.executable, script, "--root_dir",
                           str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "ckpts")
    assert not os.path.exists(tmp_path / "logs")
