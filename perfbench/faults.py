"""Faults planted in the program underneath a run, for the readings that set
the upper limits and for the tests that see ``correct`` come out false. The
benchmark's own runs plant none.

- ``unchanged``: a training step that returns its state unchanged (the step
  runs, its update is undone);
- ``half_batch``: a training step that leaves out half of its batch and
  takes the mean over the rest;
- ``no_exchange``: a data-parallel step with nothing exchanged between the
  ranks (no gradient all-reduce, SyncBN and the loss's counts local);
- ``altered``: every map altered where it is produced, its depth moved by
  one hypothesis step of the coarsest level (``depth_interval`` times its
  ratio: 10.6 mm for the variance configuration), as a map that lands one
  hypothesis off at the first level;
- ``strip``: every map altered in a band of its rows alone (the last
  twenty-fifth, 4 % of the pixels), its depth moved by five such steps
  (53 mm), as a fault confined to a few percent of the map.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half_batch", "no_exchange", "altered", "strip")


def plant(name: str | None, config: dict) -> None:
    """Patch the port's classes in this process (every rank calls it)."""
    if name is None:
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    from casmvsnet_pl_tpu_torch.engine.trainer import MVSTrainer
    step = MVSTrainer.train_step
    if name == "unchanged":
        def train_step(self, state, batch):
            before = [p.detach().clone() for p in state.model.parameters()]
            state, logs = step(self, state, batch)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return state, logs
        MVSTrainer.train_step = train_step
    elif name == "half_batch":
        def train_step(self, state, batch):
            return step(self, state, _rows(batch, len(batch["imgs"]) // 2))
        MVSTrainer.train_step = train_step
    elif name == "no_exchange":
        import torch.distributed as dist

        def all_reduce(t, *a, **k):
            return None
        dist.all_reduce = all_reduce

        def train_step(self, state, batch):
            ctx = self.replica.no_sync() if self.replica is not None \
                else contextlib.nullcontext()
            with ctx:
                return step(self, state, batch)
        MVSTrainer.train_step = train_step
    else:
        import eval_torch
        call = eval_torch.Predictor.__call__
        shift = float(config["depth_interval"]) * \
            float(config["interval_ratios"][-1])

        def predict(self, *a, **k):
            depth, conf = call(self, *a, **k)
            if name == "altered":
                return depth + shift, conf
            depth = depth.clone()
            band = max(1, round(depth.shape[-2] / 25))
            depth[..., -band:, :] += 5 * shift
            return depth, conf
        eval_torch.Predictor.__call__ = predict


def _rows(batch: dict, n: int) -> dict:
    return {k: (_rows(v, n) if isinstance(v, dict) else v[:n])
            for k, v in batch.items()}
