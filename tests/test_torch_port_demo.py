"""``demo_torch.py`` against ``demo.py``, and the port's CLIs on converted
checkpoints, on the CPU.

One JAX checkpoint (the port's seeded weights, perturbed BN statistics and
a sharpened softmax over depth, written by the JAX package's
``save_checkpoint``) runs through ``demo.py``; its conversion by
``convert_ckpt_torch.py`` runs through ``demo_torch.py``, both on the
synthetic plane scene at 64x64 in f32 with the default config. Bounds:
tests/test_torch_parity.py's 0.05 mm on depth and 1e-2 on confidence;
``acc_2mm`` within 1e-2. Then ``eval_torch.py --ckpt_path`` and
``train_torch.py --ckpt_path`` on a file converted from a reference
Lightning checkpoint: the same PFMs as the unconverted weights, and every
parameter loaded.
"""
import argparse
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_ckpt_torch
import demo
import demo_torch
import eval_torch
import train_torch
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.utils import extract_model_params as jax_params
from casmvsnet_pl_tpu.utils import load_checkpoint as jax_load_checkpoint
from casmvsnet_pl_tpu.utils import save_checkpoint as jax_save_checkpoint
from casmvsnet_pl_tpu.utils.torch_convert import convert_state_dict
from casmvsnet_pl_tpu_torch import opt as port_opt
from casmvsnet_pl_tpu_torch.data import DTUDataset, read_pfm, write_dtu_tree
from casmvsnet_pl_tpu_torch.data.png import read_png
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import load_checkpoint, save_checkpoint

DEMO_FLAGS = ["--img_wh", "64", "64", "--precision", "f32"]


def seeded_model(seed: int, **kw) -> CascadeMVSNet:
    """Seeded weights, perturbed BN statistics, a sharpened softmax over
    depth."""
    model = CascadeMVSNet(**kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.shape
                m.running_mean += torch.from_numpy(
                    rng.randn(*n).astype(np.float32) * 0.05)
                m.running_var *= torch.from_numpy(
                    1 + 0.1 * rng.rand(*n).astype(np.float32))
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    return model.eval()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(the JAX checkpoint, its conversion to the port)."""
    work = tmp_path_factory.mktemp("ckpts")
    jax_ckpt, port_ckpt = str(work / "jax.ckpt"), str(work / "port.ckpt")
    params, stats, skipped = convert_state_dict(seeded_model(11).state_dict())
    assert skipped == []
    jax_save_checkpoint(jax_ckpt, {"params": params, "batch_stats": stats,
                                   "step": np.asarray(0)})
    convert_ckpt_torch.main([jax_ckpt, port_ckpt])
    return jax_ckpt, port_ckpt


def jax_demo_maps(jax_ckpt: str):
    """``demo.py``'s forward: its sample, its model and its variables,
    ``model.apply`` -> (depth_0, confidence_0) of the one sample."""
    args = demo.get_opts(["--ckpt_path", jax_ckpt] + DEMO_FLAGS)
    sample, _ = demo.load_sample(args)
    ckpt = jax_load_checkpoint(jax_ckpt)
    variables = {"params": jax.tree.map(jnp.asarray,
                                        jax_params(ckpt)),
                 "batch_stats": jax.tree.map(jnp.asarray,
                                             ckpt["batch_stats"])}
    model = JaxCascade(num_groups=args.num_groups, dtype=jnp.float32)
    with jax.default_matmul_precision("float32"):
        out = jax.jit(model.apply)(
            variables, jnp.asarray(sample["imgs"][None]),
            jnp.asarray(sample["proj_mats"][None]),
            float(sample["init_depth_min"]), float(sample["depth_interval"]))
    return sample, np.asarray(out["depth_0"][0]), np.asarray(
        out["confidence_0"][0])


def test_demo_maps_match_demo_py(ckpts):
    jax_ckpt, port_ckpt = ckpts
    sample, want_depth, want_conf = jax_demo_maps(jax_ckpt)
    args = demo_torch.get_opts(["--cpu", "--ckpt_path", port_ckpt]
                               + DEMO_FLAGS)
    device = demo_torch.resolve_device(args)
    port_sample = demo_torch.load_sample(args)
    # the two packages' plane scenes render to float32 rounding
    for key in ("imgs", "proj_mats", "init_depth_min", "depth_interval"):
        np.testing.assert_allclose(port_sample[key], sample[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    model = demo_torch.build_model(args, device)
    depth, conf = demo_torch.predict(
        model, demo_torch.model_inputs(port_sample, device))
    depth, conf = depth[0].numpy(), conf[0].numpy()
    assert depth.shape == conf.shape == (64, 64)
    assert np.ptp(want_depth) > 1.0, "degenerate depth map"
    err = np.abs(depth - want_depth).max()
    assert err < 5e-2, f"depth_0 max err {err} mm"
    cerr = np.abs(conf - want_conf).max()
    assert cerr < 1e-2, f"confidence_0 max err {cerr}"


def _acc_2mm(out: str) -> float:
    return float(re.search(r"acc_2mm = ([0-9.]+)", out).group(1))


def test_demo_cli_matches_demo_py(ckpts, tmp_path, capsys):
    jax_ckpt, port_ckpt = ckpts
    jax_png, port_png = str(tmp_path / "demo.png"), str(tmp_path / "t.png")
    with jax.default_matmul_precision("float32"):
        demo.main(["--ckpt_path", jax_ckpt, "--time_iters", "0",
                   "--out_png", jax_png] + DEMO_FLAGS)
    want = _acc_2mm(capsys.readouterr().out)
    got = demo_torch.main(["--cpu", "--ckpt_path", port_ckpt, "--time_iters",
                           "1", "--out_png", port_png] + DEMO_FLAGS)
    out = capsys.readouterr().out
    assert abs(_acc_2mm(out) - want) < 1e-2
    assert abs(got["acc_2mm"] - want) < 1e-2
    assert "ms/view" in out and got["ms_per_view"] > 0
    assert "ref image | predicted depth | confidence | GT depth | acc_2mm=" \
        in out
    png = read_png(port_png)
    assert png.shape == (64, 5 * 64, 3) and png.dtype == np.uint8
    assert os.path.exists(jax_png)


def test_demo_panels_score_the_2mm_map():
    """``acc_2mm`` is ``demo.py``'s: the share of masked pixels within
    2 mm of the ground truth; its panel is white exactly there. (Random
    weights put the demo's depths far from the plane, where both scripts
    print 0.)"""
    sample = demo_torch.load_sample(demo_torch.get_opts(DEMO_FLAGS))
    gt = sample["depths"]["level_0"]
    depth = gt + np.where(np.arange(64)[:, None] < 16, 1.5, 2.5)
    figure, acc = demo_torch.panels(sample, depth, np.ones_like(gt) / 2)
    assert acc == 0.25
    assert [t for _, t in figure] == ["ref image", "predicted depth",
                                      "confidence", "GT depth",
                                      "acc_2mm=0.2500"]
    assert all(img.shape == (64, 64, 3) for img, _ in figure)
    assert (figure[4][0][:16] == 1).all() and (figure[4][0][16:] == 0).all()


def test_demo_defaults_to_the_card():
    args = demo_torch.get_opts([])
    assert not args.cpu and args.out_png == "demo_torch.png"
    assert demo_torch.resolve_device(demo_torch.get_opts(["--cpu"])).type \
        == "cpu"
    if torch.cuda.is_available():
        assert demo_torch.resolve_device(args).type == "cuda"
    else:
        with pytest.raises(SystemExit, match="no CUDA device"):
            demo_torch.main(["--img_wh", "64", "64"])


def test_demo_flags_match_demo_py(monkeypatch):
    def actions(module):
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args",
                      lambda self, argv=None: self)
            parser = module.get_opts([])
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    port, jax_ = actions(demo_torch), actions(demo)
    assert set(port) - set(jax_) == {"cpu"}
    for dest, want in jax_.items():
        for attr in ("option_strings", "type", "nargs", "choices"):
            assert getattr(port[dest], attr) == getattr(want, attr), dest
        if dest != "out_png":
            assert port[dest].default == want.default, dest


# -- the CLIs on a file converted from a reference Lightning checkpoint ------

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_ckpt(model, path: str) -> None:
    """``model`` saved as the reference's Lightning trainer saves it
    (``model.`` prefix, no ``num_batches_tracked``, a ``loss.`` key,
    ``hparams``), in PyTorch's legacy format."""
    sd = {"model." + k: v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["loss.weights"] = torch.ones(3)
    torch.save({"state_dict": sd, "epoch": 0,
                "hparams": argparse.Namespace(lr=1e-3)}, path,
               _use_new_zipfile_serialization=False)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(the model, its own checkpoint, the reference file converted)."""
    work = tmp_path_factory.mktemp("converted")
    model = seeded_model(13, n_depths=(8, 8, 16))
    own, raw, conv = (str(work / n) for n in ("own.ckpt", "raw.ckpt",
                                              "conv.ckpt"))
    save_checkpoint(own, {"params": dict(model.named_parameters()),
                          "batch_stats": dict(model.named_buffers())})
    reference_ckpt(model, raw)
    convert_ckpt_torch.main([raw, conv])
    return model, own, conv


def test_eval_torch_on_a_converted_file(converted, tmp_path_factory):
    model, own, conv = converted
    root = str(tmp_path_factory.mktemp("tree"))
    write_dtu_tree(root, scans=("synth1",), n_cams=5, lights=(3,))
    lists = str(tmp_path_factory.mktemp("lists"))
    with open(os.path.join(lists, "test.txt"), "w") as f:
        f.write("synth1\n")

    class Tiny(DTUDataset):
        NATIVE_WH = (256, 256)
        DEPTH_CROP = ((32, 96), (32, 96))
        N_CAMS = 5
        LISTS_DIR = lists

    cwd = os.getcwd()
    maps = {}
    for name, ckpt in (("own", own), ("converted", conv)):
        work = tmp_path_factory.mktemp(name)
        os.chdir(work)
        try:
            args = eval_torch.get_opts([
                "--cpu", "--root_dir", root, "--ckpt_path", ckpt,
                "--n_views", "3", "--img_wh", "64", "64", "--n_depths", "8",
                "8", "16", "--precision", "f32"])
            dataset = Tiny(root, "test", n_views=3, img_wh=(64, 64))
            eval_torch.run_inference(args, dataset, dataset.scans)
        finally:
            os.chdir(cwd)
        maps[name] = [read_pfm(os.path.join(
            str(work), f"results/dtu/depth/synth1/{kind}_{vid:04d}.pfm"))[0]
            for vid in range(5) for kind in ("depth", "proba")]
    assert len(maps["own"]) == 10
    assert np.ptp(maps["own"][0]) > 1.0, "degenerate depth map"
    for got, want in zip(maps["converted"], maps["own"]):
        assert np.array_equal(got, want)


def test_train_torch_warm_starts_from_a_converted_file(converted, tmp_path,
                                                       monkeypatch, capsys):
    model, _, conv = converted
    root = str(tmp_path / "tree")
    crop = ((16, 48), (16, 48))
    write_dtu_tree(root, scans=("synth1", "synth2"), n_cams=3,
                   img_wh=(32, 32), native_wh=(128, 128), focal=50.0,
                   depth_crop=crop)
    lists = os.path.join(root, "lists")
    os.makedirs(lists)
    for split, scan in (("train", "synth1"), ("val", "synth2")):
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")

    class Tiny(DTUDataset):
        NATIVE_WH = (128, 128)
        DEPTH_CROP = crop
        N_CAMS = 3
        LISTS_DIR = lists

    monkeypatch.chdir(tmp_path)
    _, state = train_torch.main(port_opt.get_opts(
        ["--cpu", "--root_dir", root, "--n_depths", "8", "8", "8",
         "--batch_size", "4", "--precision", "f32", "--num_epochs", "0",
         "--ckpt_path", conv]), Tiny)
    out = capsys.readouterr().out
    assert "ignore " not in out
    ckpt = load_checkpoint(conv)
    params = dict(state.model.named_parameters())
    assert len(params) == len(ckpt["params"]) == 130
    for k, v in model.named_parameters():
        assert torch.equal(params[k].detach(), v.detach()), k
    buffers = dict(state.model.named_buffers())
    for k, v in model.named_buffers():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(buffers[k], v), k
