"""The JAX suite's quality fit, run by the port: the 4-epoch TinyDTU recipe
and the thresholds that hold its held-out depth.

The port's copy of ``tests/conftest.py::synth_tree`` and ``quality_fit``
(the fit ``tests/test_train_loop.py::test_fit_quality_and_artifacts``
holds) and of ``scripts/tpu_convergence.py`` (the same fit on the
accelerator, through its kernels, in bf16):
  - the tree: ``data/synthetic.py::write_dtu_tree`` with scans ``synth1``
    (train, and test for the eval pipeline) and ``synth2`` (val), 5
    cameras, PNGs at 64x64, depths at 256x256, read by a ``DTUDataset``
    whose half-resize and crop give 64x64;
  - the model: ``CascadeMVSNet(n_depths=(8, 8, 16), interval_ratios=(1, 2,
    4))``, everything else at its default (FPN 32/16/8, variance, sampling
    "auto": K1/K2 on the card, their plain versions on the CPU);
  - the fit: 16 train samples shuffled by the loader's seed 0, batch 2;
    5 val samples, the last batch padded; Adam lr 1e-3, cosine over 12
    epochs, no weight decay, run for 4.

Nothing here imports JAX: the weights come in as a state dict (the JAX
package's own initial weights, converted by ``utils/convert.py::
state_dict_from_jax`` in the tests or made without JAX by
``utils/jax_init.py`` on the card), or from ``entry.py::init_weights`` of a
seed.

The recipe sits at the edge of its thresholds: its val abs_err after 4
epochs, and the fused cloud's score, depend on the initial weights (the
JAX package's fit from the port's seed-0 weights scores its cloud 15.07 mm
overall against the bound 12.0; from its own start 9.09-10.19 mm in the
port), and the final abs_err moves by tenths of a mm with the float32
summation order (``PERF.md`` §6, "training quality").
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from .. import kernels
from ..data import DataLoader, DTUDataset, write_dtu_tree
from ..entry import init_weights
from ..models import CascadeMVSNet
from ..utils.optimizers import OptimConfig
from .trainer import MVSTrainer

SCANS = {"train": "synth1", "val": "synth2", "test": "synth1"}
N_DEPTHS = (8, 8, 16)
INTERVAL_RATIOS = (1.0, 2.0, 4.0)
N_VIEWS = 3
DEPTH_INTERVAL = 2.65
N_TRAIN, N_VAL, BATCH = 16, 5, 2
OPTIM = dict(optimizer="adam", lr=1e-3, lr_scheduler="cosine",
             num_epochs=12, weight_decay=0.0)
EPOCHS = 4
# tests/test_train_loop.py:37-41, the bar of the JAX suite's fit and of
# scripts/tpu_convergence.py: the untrained model's val abs_err above
# ``before_abs_err``; after the fit a val loss below the untrained one,
# abs_err below ``abs_err`` (mm) and acc_2mm above ``acc_2mm``
THRESHOLDS = {"before_abs_err": 8.0, "abs_err": 4.0, "acc_2mm": 0.3}
# the card's fit against the f32 CPU fit from the same weights: at every
# epoch |abs_err_card - abs_err_cpu| <= max(mm, rel * abs_err_cpu)
TRACK_BAND = {"mm": 2.0, "rel": 0.2}


class Subset:
    """The first ``n`` samples of a dataset."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, min(n, len(ds))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def tiny_dtu(root: str) -> type:
    """The DTU reader of the tree :func:`write_tiny_dtu` wrote at
    ``root``."""
    class TinyDTU(DTUDataset):
        NATIVE_WH = (256, 256)
        DEPTH_CROP = ((32, 96), (32, 96))
        N_CAMS = 5
        LISTS_DIR = os.path.join(root, "lists")
    return TinyDTU


def write_tiny_dtu(root: str) -> type:
    """Write the recipe's synthetic DTU tree at ``root`` (its split lists
    under ``root/lists``); return its reader."""
    write_dtu_tree(root, scans=("synth1", "synth2"), n_cams=5)
    lists = os.path.join(root, "lists")
    os.makedirs(lists, exist_ok=True)
    for split, scan in SCANS.items():
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")
    return tiny_dtu(root)


def loaders(root: str) -> tuple[DataLoader, DataLoader]:
    """The recipe's train loader (shuffled with seed 0) and val loader."""
    dataset_cls = tiny_dtu(root)
    train_ds = Subset(dataset_cls(root, "train", n_views=N_VIEWS,
                                  depth_interval=DEPTH_INTERVAL), N_TRAIN)
    val_ds = Subset(dataset_cls(root, "val", n_views=N_VIEWS,
                                depth_interval=DEPTH_INTERVAL), N_VAL)
    train = DataLoader(train_ds, BATCH, shuffle=True, num_workers=2, seed=0)
    val = DataLoader(val_ds, BATCH, shuffle=False, drop_last=False,
                     pad_last=True, num_workers=2)
    return train, val


def model(weights: dict[str, torch.Tensor] | None = None,
          seed: int = 0) -> CascadeMVSNet:
    """The recipe's model with ``weights`` (a state dict, every name), or
    :func:`entry.init_weights` of ``seed``."""
    net = CascadeMVSNet(n_depths=N_DEPTHS, interval_ratios=INTERVAL_RATIOS)
    if weights is None:
        init_weights(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(weights, strict=True)
    return net


def _launches() -> dict[str, int]:
    return {n: getattr(kernels, n).launches for n in
            ("cost_volume_cuda", "cost_volume_bwd_cuda", "prob_conv_cuda")}


def expected_launches(epochs: int, panels: bool) -> dict[str, int]:
    """Kernel launches of a :func:`quality_fit` on the card: 3 K1 + 3 K2 a
    train step, 3 K1 a val batch (before, each epoch, after) and, with a
    ``log_dir``, 3 K1 for each epoch's train panel (the val panel reuses its
    batch's outputs); the ``prob`` conv's kernel as K1, 3 a forward."""
    steps, val = N_TRAIN // BATCH, -(-N_VAL // BATCH)
    forwards = steps * epochs + val * (epochs + 2) + (epochs if panels else 0)
    return {"cost_volume_cuda": 3 * forwards,
            "cost_volume_bwd_cuda": 3 * steps * epochs,
            "prob_conv_cuda": 3 * forwards}


def quality_fit(root: str, device, dtype: torch.dtype,
                weights: dict[str, torch.Tensor] | None = None, seed: int = 0,
                epochs: int = EPOCHS, ckpt_dir: str | None = None,
                log_dir: str | None = None) -> dict:
    """The recipe on the tree at ``root`` (:func:`write_tiny_dtu`), from
    ``weights`` or the seed's, in compute ``dtype`` on ``device``.

    Returns ``before`` and ``after`` (val metrics of the untrained and the
    fitted model), ``epochs`` (each epoch's val metrics), ``launches`` (K1,
    K2 and the ``prob`` conv's kernel during the fit), ``step_ms`` (median wall time of a train step,
    a sync each, the loader's wait included, from step 3), ``wall_s`` and
    the fitted ``state``."""
    train, val = loaders(root)
    trainer = MVSTrainer(model(weights, seed), OptimConfig(**OPTIM),
                         steps_per_epoch=len(train), device=device,
                         dtype=dtype, ckpt_dir=ckpt_dir, log_dir=log_dir,
                         time_steps=True)
    t0 = time.perf_counter()
    launches = _launches()
    state = trainer.init_state()
    before = trainer.validate(state, val)
    state = trainer.fit(state, train, val, num_epochs=epochs,
                        progress=False)
    after = trainer.validate(state, val)
    if trainer.writer is not None:
        trainer.writer.close()
    launches = {k: v - launches[k] for k, v in _launches().items()}
    times = trainer.step_times
    return {"before": before, "after": after,
            "epochs": list(trainer.epoch_metrics), "launches": launches,
            "step_ms": statistics.median(t["step_s"] for t in times[2:])
            * 1e3 if len(times) > 2 else float("nan"),
            "wall_s": time.perf_counter() - t0, "state": state}


def threshold_failures(fit: dict) -> list[str]:
    """What of :data:`THRESHOLDS` a :func:`quality_fit` misses (empty when
    it meets them all)."""
    before, after = fit["before"], fit["after"]
    failures = []
    if not before["val/abs_err"] > THRESHOLDS["before_abs_err"]:
        failures.append(f"untrained abs_err {before['val/abs_err']!r} <= "
                        f"{THRESHOLDS['before_abs_err']}")
    if not (np.isfinite(after["val/loss"])
            and after["val/loss"] < before["val/loss"]):
        failures.append(f"val loss {before['val/loss']!r} -> "
                        f"{after['val/loss']!r} did not fall")
    if not after["val/abs_err"] < THRESHOLDS["abs_err"]:
        failures.append(f"abs_err {after['val/abs_err']!r} >= "
                        f"{THRESHOLDS['abs_err']}")
    if not after["val/acc_2mm"] > THRESHOLDS["acc_2mm"]:
        failures.append(f"acc_2mm {after['val/acc_2mm']!r} <= "
                        f"{THRESHOLDS['acc_2mm']}")
    return failures


def trajectory(fit: dict) -> list[float]:
    """val abs_err before the fit and after each epoch."""
    return [fit["before"]["val/abs_err"]] + [
        m["val/abs_err"] for m in fit["epochs"]]


def track_failures(got: list[float], ref: list[float]) -> list[str]:
    """The points of trajectory ``got`` outside :data:`TRACK_BAND` of the
    reference trajectory ``ref`` (empty when every one is inside)."""
    failures = []
    for i, (g, r) in enumerate(zip(got, ref, strict=True)):
        band = max(TRACK_BAND["mm"], TRACK_BAND["rel"] * r)
        if not abs(g - r) <= band:
            failures.append(f"{'before' if i == 0 else f'epoch {i}'}: "
                            f"abs_err {g!r} against {r!r} (band {band!r})")
    return failures
