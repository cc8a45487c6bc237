"""The port's checkpoints: round trip, partial load, top-k, and full resume
of the trainer, on the CPU."""
import os

import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.entry import train_entry
from casmvsnet_pl_tpu_torch.utils import (TopKCheckpointManager,
                                          extract_model_params,
                                          load_checkpoint, partial_load,
                                          save_checkpoint)

SMALL = dict(img_wh=(32, 32), n_depths=(8, 8, 8))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"params": {"a": torch.arange(6.0).reshape(2, 3)},
            "opt_state": {"state": {0: {"step": torch.tensor(3.0)}},
                          "param_groups": [{"lr": 1e-3,
                                            "betas": (0.9, 0.999)}]},
            "step": 7}
    p = str(tmp_path / "sub" / "m.ckpt")
    save_checkpoint(p, tree)
    assert os.listdir(tmp_path / "sub") == ["m.ckpt"]   # no temp file left
    back = load_checkpoint(p)
    torch.testing.assert_close(back["params"]["a"], tree["params"]["a"])
    assert back["step"] == 7
    assert back["opt_state"]["param_groups"][0]["betas"] == (0.9, 0.999)


def test_partial_load_with_prefixes():
    sd = {"feature.w": torch.zeros(2, 2), "head.w": torch.zeros(3),
          "loss.t": torch.zeros(1)}
    ckpt = {"params": {"feature.w": torch.ones(2, 2),
                       "head.w": torch.ones(4),              # shape mismatch
                       "loss.t": torch.ones(1)},
            "opt_state": {}}
    params = extract_model_params(ckpt)
    assert sorted(params) == ["feature.w", "head.w", "loss.t"]
    assert sorted(extract_model_params(ckpt, ("loss",))) == ["feature.w",
                                                             "head.w"]
    new, loaded, skipped = partial_load(sd, params,
                                        prefixes_to_ignore=("loss",))
    assert torch.equal(new["feature.w"], torch.ones(2, 2))
    assert torch.equal(new["head.w"], torch.zeros(3))        # kept fresh
    assert torch.equal(new["loss.t"], torch.zeros(1))        # ignored
    assert loaded == ["feature.w"]
    assert set(skipped) == {"head.w", "loss.t"}


def test_topk_manager(tmp_path):
    mgr = TopKCheckpointManager(str(tmp_path), monitor="val/acc_2mm",
                                mode="max", top_k=2)
    tree = {"params": {"w": torch.zeros(1)}}
    assert mgr.save(tree, {"val/acc_2mm": 0.5}, epoch=0)
    assert mgr.save(tree, {"val/acc_2mm": 0.7}, epoch=1)
    assert not mgr.save(tree, {"val/acc_2mm": 0.4}, epoch=2)  # below top-2
    assert mgr.save(tree, {"val/acc_2mm": 0.9}, epoch=3)      # evicts 0.5
    kept = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert kept == ["epoch=01.ckpt", "epoch=03.ckpt"]
    assert mgr.best_path().endswith("epoch=03.ckpt")
    mgr2 = TopKCheckpointManager(str(tmp_path), monitor="val/acc_2mm",
                                 mode="max", top_k=2)        # restartable
    assert mgr2.best_path().endswith("epoch=03.ckpt")
    with pytest.raises(ValueError):
        TopKCheckpointManager(str(tmp_path), mode="median")


@pytest.fixture
def one_thread():
    """The CPU backward's scatter-adds (the plain cost volume's gathers)
    sum in a thread-dependent order with several threads; bit-exact
    comparisons run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_full_resume_is_bit_exact(tmp_path, optimizer, one_thread):
    """k steps, save, restore into a fresh trainer, one more step: equal,
    bit for bit, to k+1 uninterrupted steps (parameters, BatchNorm
    statistics, optimizer state, step, logs)."""
    k = 2
    trainer, state, batch = train_entry("cpu", optimizer=optimizer, **SMALL)
    for _ in range(k):
        state, _ = trainer.train_step(state, batch)
    path = str(tmp_path / "k.ckpt")
    save_checkpoint(path, trainer.checkpoint_tree(state))
    state, logs = trainer.train_step(state, batch)

    other, _, _ = train_entry("cpu", optimizer=optimizer, seed=1, **SMALL)
    resumed = other.restore_state(path)
    assert resumed.step == k
    resumed, logs_r = other.train_step(resumed, batch)
    assert resumed.step == state.step == k + 1
    for key in logs:
        assert float(logs_r[key]) == float(logs[key]), key
    want, got = state.model.state_dict(), resumed.model.state_dict()
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    ow, og = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in ow["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(og["state"][i][key]),
                               torch.as_tensor(v)), (i, key)


def test_ranger_checkpoint_holds_slow_weights(tmp_path):
    trainer, state, batch = train_entry("cpu", optimizer="ranger", **SMALL)
    for _ in range(7):                       # one Lookahead sync, then 1
        state, _ = trainer.train_step(state, batch)
    tree = trainer.checkpoint_tree(state)
    slow = dict(zip([n for n, _ in state.model.named_parameters()],
                    state.optimizer.slow_params()))
    fast = dict(state.model.named_parameters())
    name = "cost_reg_0.conv0.conv.weight"
    assert torch.equal(tree["params"][name], slow[name])
    assert not torch.equal(slow[name], fast[name].detach())
    path = str(tmp_path / "r.ckpt")
    save_checkpoint(path, tree)
    resumed = trainer.restore_state(path)
    # as the JAX package: the fast weights restart from the slow ones
    assert torch.equal(dict(resumed.model.named_parameters())[name].detach(),
                       slow[name])
    assert resumed.optimizer.steps_since_sync == 1
    sums, _ = trainer.val_step(resumed, batch)
    assert np.isfinite(float(sums["loss"]))
