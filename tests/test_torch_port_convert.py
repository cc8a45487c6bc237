"""Checkpoints from outside the port (``utils/torch_convert.py``,
``utils/msgpack.py``, ``convert_ckpt_torch.py``) against the JAX package.

Files in the reference's layout are built here from the port's seeded
weights with perturbed BN statistics (a ``model.`` prefix, a ``loss.`` key,
no ``num_batches_tracked``, ``hparams``, optimizer and scheduler objects),
in PyTorch's zip and legacy formats; JAX checkpoints are written by the
JAX trainer's ``save_checkpoint``. The port's forward from a converted file
must match the JAX forward from the JAX package's reading of the same file
within tests/test_torch_parity.py's bounds: 0.05 mm on depth, 1e-2 on
confidence (64x64, n_depths 8/16/16, as tests/test_torch_port_cascade.py).
"""
import argparse
import collections
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu.engine import MVSTrainer as JaxTrainer
from casmvsnet_pl_tpu.models import CascadeMVSNet as JaxCascade
from casmvsnet_pl_tpu.parallel import make_mesh
from casmvsnet_pl_tpu.utils import OptimConfig as JaxOptimConfig
from casmvsnet_pl_tpu.utils import save_checkpoint as jax_save_checkpoint
from casmvsnet_pl_tpu.utils.torch_convert import (convert_state_dict,
                                                  convert_torch_checkpoint)
from casmvsnet_pl_tpu_torch.data import PlaneScene
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import (convert_checkpoint,
                                          extract_model_params,
                                          jax_from_state_dict,
                                          load_checkpoint,
                                          state_dict_from_jax)
from casmvsnet_pl_tpu_torch.utils import msgpack
from casmvsnet_pl_tpu_torch.utils.torch_convert import split_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEPTHS, RATIOS = (8, 16, 16), (1.0, 2.0, 4.0)


def seeded_model(seed: int = 5) -> CascadeMVSNet:
    """Seeded weights, perturbed BN statistics and a sharpened softmax over
    depth (so that the depths spread over the sweep)."""
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
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
                m.weight += torch.from_numpy(
                    rng.randn(*n).astype(np.float32) * 0.1)
        for l in range(3):
            getattr(model, f"cost_reg_{l}").prob.weight *= 30.0
    return model.eval()


def reference_blob(model, hparams: str, wrapper: bool):
    """What the reference's Lightning trainer saves (PL 0.7.5): the
    model's weights under ``model.`` without ``num_batches_tracked``, the
    loss's buffer, ``hparams``, optimizer and scheduler state (a scheduler
    object, as the warm-up scheduler pickles its ``after_scheduler``).
    Without the wrapper the weights sit at the top of the dict."""
    sd = collections.OrderedDict(
        ("model." + k, v.clone()) for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked"))
    sd["loss.weights"] = torch.ones(3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, 16)
    hp = {"lr": 1e-3, "n_depths": [8, 32, 48], "exp_name": "exp"}
    hp = argparse.Namespace(**hp) if hparams == "namespace" else hp
    if not wrapper:
        sd["hparams"] = hp
        return sd
    return {"epoch": 15, "global_step": 12345,
            "checkpoint_callback_best": 0.8, "state_dict": sd,
            "hparams": hp, "optimizer_states": [opt.state_dict()],
            "lr_schedulers": [{"after_scheduler": sched,
                               "last_epoch": 15}]}


def scene_inputs():
    scene = PlaneScene(img_wh=(64, 64), n_views=3, z0=460.0, baseline=12.0,
                       focal=120.0, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    return (imgs, proj, np.array([425.0], np.float32),
            np.array([2.65], np.float32))


@pytest.fixture(scope="module")
def jax_forward():
    """One jitted JAX forward at the tests' config: (params, stats) ->
    {depth_l, confidence_l} numpy."""
    inputs = [jnp.asarray(x) for x in scene_inputs()]
    apply = jax.jit(JaxCascade(n_depths=N_DEPTHS,
                               interval_ratios=RATIOS).apply)

    def run(params, stats):
        with jax.default_matmul_precision("float32"):
            out = apply({"params": params, "batch_stats": stats}, *inputs)
        return {k: np.asarray(v) for k, v in out.items()}
    return run


def port_forward(ckpt: dict) -> dict:
    model = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
    model.load_state_dict({**extract_model_params(ckpt),
                           **ckpt["batch_stats"]}, strict=True)
    with torch.no_grad():
        out = model.eval()(*(torch.from_numpy(x) for x in scene_inputs()))
    return {k: v.numpy() for k, v in out.items()}


def assert_forwards_match(got: dict, want: dict) -> None:
    for lvl in range(3):
        rd, gd = want[f"depth_{lvl}"], got[f"depth_{lvl}"]
        assert gd.shape == rd.shape == (1, 64 >> lvl, 64 >> lvl)
        assert np.ptp(rd) > 1.0, "degenerate depth map"
        err = np.abs(gd - rd).max()
        assert err < 5e-2, f"depth_{lvl} max err {err} mm"
        cerr = np.abs(got[f"confidence_{lvl}"]
                      - want[f"confidence_{lvl}"]).max()
        assert cerr < 1e-2, f"confidence_{lvl} max err {cerr}"


def assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("wrapper", [True, False],
                         ids=["state_dict", "bare"])
@pytest.mark.parametrize("hparams", ["namespace", "dict"])
@pytest.mark.parametrize("zipfile", [True, False], ids=["zip", "legacy"])
def test_reference_ckpt_matches_jax_conversion(tmp_path, capsys, jax_forward,
                                               zipfile, hparams, wrapper):
    model = seeded_model()
    path = str(tmp_path / "epoch.15.ckpt")
    torch.save(reference_blob(model, hparams, wrapper), path,
               _use_new_zipfile_serialization=zipfile)
    with open(path, "rb") as f:
        assert f.read(2) == (b"PK" if zipfile else b"\x80\x02")

    ckpt = convert_checkpoint(path)
    port_said = capsys.readouterr().out
    ref = convert_torch_checkpoint(path)
    jax_said = capsys.readouterr().out
    assert port_said == jax_said and "loss.weights" in port_said

    # every weight is the model's own, and num_batches_tracked is back
    want = model.state_dict()
    got = {**ckpt["params"], **ckpt["batch_stats"]}
    assert_state_equal(got, want)
    assert sorted(ckpt["params"]) == sorted(
        k for k, _ in model.named_parameters())
    assert_forwards_match(port_forward(ckpt),
                          jax_forward(ref["params"], ref["batch_stats"]))


def test_skipped_keys_are_the_jax_converters():
    model = seeded_model()
    sd = reference_blob(model, "dict", True)["state_dict"]
    sd["model.feature.conv0.0.bn.extra"] = torch.ones(1)
    sd["model.cost_reg_0.conv0.bn.num_batches_tracked"] = torch.tensor(7)
    _, _, want = convert_state_dict(sd)
    params, stats, got = split_state_dict(sd, "sd")
    assert got == want == ["loss.weights", "feature.conv0.0.bn.extra"]
    assert stats["cost_reg_0.conv0.bn.num_batches_tracked"].item() == 7
    assert stats["feature.conv0.0.bn.num_batches_tracked"].item() == 0


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX trainer's initial state (Adam), its BN statistics perturbed
    and its softmax sharpened, saved as ``fit`` saves it: (path, params,
    batch_stats)."""
    imgs, proj, dmin, dint = scene_inputs()
    batch = {"imgs": imgs, "proj_mats": proj, "init_depth_min": dmin,
             "depth_interval": dint}
    trainer = JaxTrainer(JaxCascade(n_depths=N_DEPTHS,
                                    interval_ratios=RATIOS),
                         JaxOptimConfig(optimizer="adam", lr=1e-3),
                         steps_per_epoch=4, mesh=make_mesh(1))
    state = trainer.init_state(batch, seed=2)
    params = jax.tree.map(np.array, trainer.model_params(state))
    stats = jax.tree.map(np.array, state.batch_stats)
    rng = np.random.RandomState(2)
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        leaf += (rng.randn(*leaf.shape) * 0.05 if path[-1].key == "mean"
                 else rng.rand(*leaf.shape) * 0.1).astype(np.float32)
    for l in range(3):
        params[f"cost_reg_{l}"]["prob"]["kernel"] *= 30.0
    path = str(tmp_path_factory.mktemp("jax") / "last.ckpt")
    jax_save_checkpoint(path, {"params": params, "batch_stats": stats,
                               "opt_state": state.opt_state,
                               "step": np.asarray(3)})
    return path, params, stats


def test_jax_checkpoint_converts_exactly(jax_ckpt, jax_forward, capsys):
    path, params, stats = jax_ckpt
    ckpt = convert_checkpoint(path)
    assert capsys.readouterr().out == ""             # nothing skipped
    assert_state_equal({**ckpt["params"], **ckpt["batch_stats"]},
                       state_dict_from_jax(params, stats))
    assert_forwards_match(port_forward(ckpt), jax_forward(params, stats))


def _assert_trees_equal(got, want, path="tree"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert got == want, path


def test_msgpack_reads_and_writes_the_jax_checkpoint(jax_ckpt):
    path = jax_ckpt[0]
    with open(path, "rb") as f:
        data = f.read()
    tree = msgpack.restore(data)
    _assert_trees_equal(tree, flax.serialization.msgpack_restore(data))
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "step"]
    assert msgpack.serialize(tree) == data


def test_msgpack_matches_flax_on_every_kind(monkeypatch):
    tree = {"scalar": np.float32(2.5), "int_scalar": np.int64(-7),
            "flag": True, "off": np.bool_(False), "none": None,
            "nested": [1, [2.5, "x" * 40, b"\x00\xff"], {"k": np.ones(3)}],
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                     -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "empty": np.zeros((0, 4), np.float32),
            "big": np.arange(5000, dtype=np.float32).reshape(50, 100),
            "deep": {"big": np.arange(300, dtype=np.int16)},
            "map16": {f"k{i:02d}": i for i in range(20)}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 512)
    data = flax.serialization.msgpack_serialize(tree)
    assert msgpack.serialize(tree, max_chunk_bytes=512) == data
    assert msgpack.unpackb(data)["big"][msgpack.CHUNKED] is True
    _assert_trees_equal(msgpack.restore(data),
                        flax.serialization.msgpack_restore(data))


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"), ("trailing", "bytes after the object"),
    ("complex", "ext type 2"), ("int_key", "key of type int")])
def test_msgpack_refuses_what_flax_did_not_write(tmp_path, case, match):
    good = flax.serialization.msgpack_serialize(
        {"params": {"w": np.ones((4, 4), np.float32)}})
    data = {"truncated": good[:-5], "trailing": good + b"\x00",
            "complex": flax.serialization.msgpack_serialize({"c": 1 + 2j}),
            "int_key": b"\x81\x01\x02"}[case]
    with pytest.raises(msgpack.MsgpackError, match=match):
        msgpack.restore(data)
    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match) as info:
        convert_checkpoint(path)
    assert path in str(info.value)


class _Payload:
    """Pickles as a call of ``exec`` that would write the marker file."""

    def __init__(self, marker: str):
        self.marker = marker

    def __reduce__(self):
        return exec, (f"open({self.marker!r}, 'w').close()",)


@pytest.mark.parametrize("where", ["hparams", "top", "weight"])
@pytest.mark.parametrize("zipfile", [True, False], ids=["zip", "legacy"])
def test_pickled_globals_outside_the_allow_list_never_run(tmp_path, zipfile,
                                                          where):
    marker = str(tmp_path / "marker")
    blob = reference_blob(seeded_model(), "dict", True)
    if where == "hparams":
        blob["hparams"] = _Payload(marker)
    elif where == "weight":
        blob["state_dict"]["model.cost_reg_2.prob.weight"] = _Payload(marker)
    else:
        blob = _Payload(marker)
    path = str(tmp_path / "evil.ckpt")
    torch.save(blob, path, _use_new_zipfile_serialization=zipfile)
    if where == "hparams":
        ckpt = convert_checkpoint(path)
        assert len(ckpt["params"]) == 130
    else:
        with pytest.raises(ValueError, match="StandIn|not a tensor"):
            convert_checkpoint(path)
    assert not os.path.exists(marker)


def test_missing_weights_raise_and_name_the_key(tmp_path, jax_ckpt):
    blob = reference_blob(seeded_model(), "namespace", True)
    del blob["state_dict"]["model.cost_reg_2.prob.weight"]
    del blob["state_dict"]["model.feature.conv0.0.bn.running_var"]
    path = str(tmp_path / "partial.ckpt")
    torch.save(blob, path)
    with pytest.raises(ValueError) as info:
        convert_checkpoint(path)
    msg = str(info.value)
    assert path in msg and "missing cost_reg_2.prob.weight" in msg
    assert "feature.conv0.0.bn.running_var" in msg

    _, params, stats = jax_ckpt
    params = jax.tree.map(np.array, params)
    del params["cost_reg_2"]["prob"]["kernel"]
    path = str(tmp_path / "partial_jax.ckpt")
    jax_save_checkpoint(path, {"params": params})     # no batch_stats
    with pytest.raises(ValueError, match="missing ") as info:
        convert_checkpoint(path)
    msg = str(info.value)
    assert path in msg and "cost_reg_2.prob.weight" in msg
    assert "cost_reg_0.conv0.bn.running_mean" in msg

    path = str(tmp_path / "noise.bin")
    with open(path, "wb") as f:
        f.write(b"GIF89a" + bytes(100))
    with pytest.raises(ValueError, match="neither a PyTorch file"):
        convert_checkpoint(path)


def test_jax_from_state_dict_is_the_jax_converter():
    sd = seeded_model(7).state_dict()
    params, stats = jax_from_state_dict(sd)
    want_params, want_stats, skipped = convert_state_dict(sd)
    assert skipped == []
    _assert_trees_equal(params, jax.tree.map(np.asarray, want_params))
    _assert_trees_equal(stats, jax.tree.map(np.asarray, want_stats))
    assert_state_equal(state_dict_from_jax(params, stats), sd)


def test_load_checkpoint_names_the_converter(tmp_path, jax_ckpt):
    model = seeded_model()
    raw = str(tmp_path / "raw.ckpt")
    torch.save(reference_blob(model, "namespace", True), raw,
               _use_new_zipfile_serialization=False)
    lightning = str(tmp_path / "lightning_weights_only.ckpt")
    torch.save({"state_dict": model.state_dict(), "epoch": 3}, lightning)
    for path in (raw, lightning, jax_ckpt[0]):
        with pytest.raises(ValueError, match="convert_ckpt_torch.py"):
            load_checkpoint(path)


def test_convert_ckpt_torch_cli(tmp_path):
    model = seeded_model()
    src, dst = str(tmp_path / "epoch.15.ckpt"), str(tmp_path / "port.ckpt")
    torch.save(reference_blob(model, "namespace", True), src,
               _use_new_zipfile_serialization=False)
    proc = subprocess.run([sys.executable,
                           os.path.join(REPO, "convert_ckpt_torch.py"), src,
                           dst], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "convert: skipped 1 non-model keys: ['loss.weights']" in \
        proc.stdout
    assert "130 parameter tensors, 0.93M params" in proc.stdout
    ckpt = load_checkpoint(dst)
    fresh = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=RATIOS)
    fresh.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]},
                          strict=True)
    assert_state_equal(fresh.state_dict(), model.state_dict())
