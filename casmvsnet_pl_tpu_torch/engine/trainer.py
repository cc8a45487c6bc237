"""Training system: train and validation steps, validation, fit, resume.

Counterpart of ``casmvsnet_pl_tpu/engine/trainer.py`` and ``engine/
state.py`` on one device:
  - train step = forward in train mode (BatchNorm on batch statistics) +
    multi-scale masked SL1 + metrics, with the learning rate of the step's
    schedule;
  - validation sums pixel-weighted metrics over batches and divides once
    (sum-then-divide); ``val/loss`` is the mean over batches;
  - top-k checkpoints on val/acc_2mm (max, k=5) and ``last.ckpt``, each
    with parameters, BatchNorm statistics, optimizer state and step, so
    :meth:`MVSTrainer.restore_state` resumes fully;
  - TensorBoard scalars when a ``log_dir`` is given (``tensorboardX``,
    imported only then).

Precision: parameters, BatchNorm statistics and optimizer state stay in
float32; ``dtype`` is the compute dtype of the convolutions and the cost
volume, applied with ``torch.autocast`` (bf16 on the card). Projection,
softmax, depth regression, loss and metrics run in float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Iterable, Iterator

import torch
import torch.nn as nn

from ..data.loader import prefetch_to_device, to_device
from ..losses import sl1_loss
from ..metrics import abs_error_mean, acc_threshold_mean, metric_sums
from ..ops.plane_sweep import build_cost_volume
from ..utils.checkpoints import (TopKCheckpointManager, load_checkpoint,
                                 save_checkpoint)
from ..utils.optimizers import (Lookahead, OptimConfig, make_lr_schedule,
                                make_optimizer, set_lr)

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """Optimization step, the model (fast parameters when ranger, and
    BatchNorm statistics) and its optimizer (with ranger's slow weights)."""
    step: int
    model: nn.Module
    optimizer: object


def model_batch_args(batch: dict) -> tuple:
    return (batch["imgs"], batch["proj_mats"], batch["init_depth_min"],
            batch["depth_interval"])


class MVSTrainer:
    def __init__(self, model: nn.Module, optim_cfg: OptimConfig,
                 steps_per_epoch: int, device="cpu",
                 dtype: torch.dtype = torch.float32,
                 ckpt_dir: str | None = None, log_dir: str | None = None,
                 levels: int = 3, monitor: str = "val/acc_2mm",
                 top_k: int = 5,
                 cost_volume: Callable = build_cost_volume):
        self.model = model
        self.cfg = optim_cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.dtype = dtype
        self.levels = levels
        self.cost_volume = cost_volume
        self.schedule = make_lr_schedule(optim_cfg, steps_per_epoch)
        self.ckpt_mgr = (TopKCheckpointManager(ckpt_dir, monitor=monitor,
                                               top_k=top_k)
                         if ckpt_dir else None)
        self.ckpt_dir = ckpt_dir
        self.writer = None
        if log_dir:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(log_dir)

    # -- state -------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Step 0: the model's current weights in float32 on the device, and
        a fresh optimizer."""
        model = self.model.to(device=self.device, dtype=torch.float32)
        optimizer, _ = make_optimizer(self.cfg, self.steps_per_epoch,
                                      model.parameters())
        return TrainState(0, model, optimizer)

    def model_params(self, state: TrainState) -> dict[str, Tensor]:
        """Parameters for inference by name (the slow weights with ranger)."""
        params = dict(state.model.named_parameters())
        if isinstance(state.optimizer, Lookahead):
            params = dict(zip(params, state.optimizer.slow_params()))
        return {k: v.detach() for k, v in params.items()}

    def checkpoint_tree(self, state: TrainState) -> dict:
        return {"params": self.model_params(state),
                "batch_stats": {k: v.detach() for k, v in
                                state.model.named_buffers()},
                "opt_state": state.optimizer.state_dict(),
                "step": state.step}

    def restore_state(self, path: str) -> TrainState:
        """Full resume from a checkpoint written by :meth:`fit`: parameters,
        BatchNorm statistics, optimizer state and step. With ranger the
        fast weights restart from the saved slow ones, as in the JAX
        package."""
        ckpt = load_checkpoint(path)
        self.model.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]},
                                   strict=True)
        state = self.init_state()
        state.optimizer.load_state_dict(ckpt["opt_state"])
        state.step = int(ckpt["step"])
        return state

    # -- steps -------------------------------------------------------------
    def _autocast(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def device_batch(self, batch: dict) -> dict:
        """numpy batch -> tensors on the trainer's device."""
        return to_device(batch, self.device)

    def train_step(self, state: TrainState,
                   batch: dict) -> tuple[TrainState, dict]:
        """One optimization step on a device batch; returns the state
        (updated in place) and the step's logs as 0-d tensors, ``lr`` as a
        float."""
        model, optimizer = state.model, state.optimizer
        model.train()
        lr = self.schedule(state.step)
        set_lr(optimizer, lr)
        with self._autocast():
            outs = model(*model_batch_args(batch),
                         cost_volume=self.cost_volume)
        loss = sl1_loss(outs, batch["depths"], batch["masks"], self.levels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.step += 1
        pred = outs["depth_0"].detach()
        gt, mask = batch["depths"]["level_0"], batch["masks"]["level_0"]
        logs = {
            "train/loss": loss.detach(),
            "train/abs_err": abs_error_mean(pred, gt, mask),
            "train/acc_1mm": acc_threshold_mean(pred, gt, mask, 1.0),
            "train/acc_2mm": acc_threshold_mean(pred, gt, mask, 2.0),
            "train/acc_4mm": acc_threshold_mean(pred, gt, mask, 4.0),
            "lr": lr,
        }
        return state, logs

    def val_step(self, state: TrainState,
                 batch: dict) -> tuple[dict, dict]:
        """Eval-mode forward (running statistics; ranger's slow weights);
        returns the metric sums with ``loss``, and the outputs."""
        model = state.model
        model.eval()
        args = model_batch_args(batch)
        with torch.no_grad(), self._autocast():
            if isinstance(state.optimizer, Lookahead):
                outs = torch.func.functional_call(
                    model, self.model_params(state), args,
                    {"cost_volume": self.cost_volume})
            else:
                outs = model(*args, cost_volume=self.cost_volume)
        loss = sl1_loss(outs, batch["depths"], batch["masks"], self.levels)
        sums = metric_sums(outs["depth_0"], batch["depths"]["level_0"],
                           batch["masks"]["level_0"])
        sums["loss"] = loss
        return sums, outs

    # -- loops -------------------------------------------------------------
    def _prefetch(self, loader: Iterable) -> Iterator[dict]:
        for batch in prefetch_to_device(iter(loader), self.device):
            batch.pop("scan_vid", None)
            yield batch

    def validate(self, state: TrainState, val_loader: Iterable,
                 epoch: int = 0, global_step: int = 0) -> dict[str, float]:
        totals: dict[str, float] = {}
        n_batches = 0
        for batch in self._prefetch(val_loader):
            sums, _ = self.val_step(state, batch)
            for k, v in sums.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n_batches += 1
        mask_sum = max(totals.get("mask_sum", 0.0), 1.0)
        metrics = {
            "val/loss": totals.get("loss", 0.0) / max(n_batches, 1),
            "val/abs_err": totals.get("abs_err_sum", 0.0) / mask_sum,
            "val/acc_1mm": totals.get("acc_1mm_sum", 0.0) / mask_sum,
            "val/acc_2mm": totals.get("acc_2mm_sum", 0.0) / mask_sum,
            "val/acc_4mm": totals.get("acc_4mm_sum", 0.0) / mask_sum,
        }
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, v, global_step)
        return metrics

    def fit(self, state: TrainState, train_loader, val_loader,
            num_epochs: int, log_every: int = 50,
            progress: bool = True) -> TrainState:
        for epoch in range(num_epochs):
            t0 = time.time()
            iterator = self._prefetch(train_loader)
            if progress:
                from tqdm import tqdm
                iterator = tqdm(iterator, desc=f"epoch {epoch}",
                                total=len(train_loader), leave=False)
            for batch_nb, batch in enumerate(iterator):
                state, logs = self.train_step(state, batch)
                if self.writer is not None and (state.step % log_every == 0
                                                or batch_nb == 0):
                    for k, v in logs.items():
                        self.writer.add_scalar(k, float(v), state.step)
            metrics = self.validate(state, val_loader, epoch, state.step)
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.save(self.checkpoint_tree(state), metrics,
                                   epoch)
            if self.ckpt_dir:
                save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"),
                                self.checkpoint_tree(state))
            print(f"epoch {epoch}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in metrics.items()) +
                  f" ({time.time() - t0:.1f}s)")
        return state
