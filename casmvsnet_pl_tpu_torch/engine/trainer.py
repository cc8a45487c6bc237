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
  - TensorBoard scalars and [image|GT|pred|prob] panels, of the first
    train batch (one extra eval-mode forward) and of the first val batch
    (its own outputs), when a ``log_dir`` is given
    (``utils/tensorboard.py``, the port's own event writer);
  - data parallelism when this process is one rank of several
    (``parallel/``): the model wrapped in ``DistributedDataParallel``
    (buffers not broadcast: BatchNorm statistics are already global), the
    loss, the logged metrics and the validation sums over the global
    batch; rank 0 alone writes checkpoints (then a barrier), events and
    prints.

Precision: parameters, BatchNorm statistics and optimizer state stay in
float32 (everything is float64 when ``dtype`` is, a reference for tests on
the CPU); ``dtype`` is the compute dtype of the convolutions and the cost
volume, applied with ``torch.autocast`` (bf16 on the card). Projection,
softmax, depth regression, loss and metrics run in float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.nn as nn

from ..data.base import unnormalize_image
from ..data.loader import prefetch_to_device, to_device
from ..losses import sl1_loss
from ..metrics import batch_means, metric_sums
from ..parallel import all_reduce_dict, all_reduce_sum, barrier, \
    check_same_on_ranks, rank, world_size
from ..utils.checkpoints import (TopKCheckpointManager, load_checkpoint,
                                 save_checkpoint)
from ..utils.optimizers import (Lookahead, OptimConfig, make_lr_schedule,
                                make_optimizer, set_lr)
from ..utils.tensorboard import SummaryWriter
from ..utils.visualization import visualize_depth, visualize_prob

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
                 steps_per_epoch: int, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 ckpt_dir: str | None = None, log_dir: str | None = None,
                 levels: int = 3, monitor: str = "val/acc_2mm",
                 top_k: int = 5,
                 cost_volume: Callable | None = None,
                 time_steps: bool = False):
        self.model = model
        self.cfg = optim_cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.dtype = dtype
        # float64 (a reference for tests on the CPU) keeps everything in
        # float64; any other compute dtype keeps float32 parameters
        self.param_dtype = torch.float64 if dtype == torch.float64 \
            else torch.float32
        self.levels = levels
        self.cost_volume = cost_volume
        self.schedule = make_lr_schedule(optim_cfg, steps_per_epoch)
        self.rank, self.world = rank(), world_size()
        self.distributed = self.world > 1
        self.replica = None     # the DistributedDataParallel wrapper
        lead = self.rank == 0
        self.ckpt_mgr = (TopKCheckpointManager(ckpt_dir, monitor=monitor,
                                               top_k=top_k)
                         if ckpt_dir and lead else None)
        self.ckpt_dir = ckpt_dir
        self.writer = SummaryWriter(log_dir) if log_dir and lead else None
        # with time_steps, fit synchronizes after every train step and
        # records {"wait_s", "step_s", "loss"} of it here
        self.step_times: list[dict] | None = [] if time_steps else None
        # fit appends each epoch's validation metrics here
        self.epoch_metrics: list[dict[str, float]] = []

    # -- state -------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Step 0: the model's current weights in float32 on the device, and
        a fresh optimizer (and the data-parallel wrapper, several ranks)."""
        model = self.model.to(device=self.device, dtype=self.param_dtype)
        if self.distributed:
            from torch.nn.parallel import DistributedDataParallel
            self.replica = DistributedDataParallel(
                model, device_ids=([self.device.index]
                                   if self.device.type == "cuda" else None),
                broadcast_buffers=False)
        optimizer, _ = make_optimizer(self.cfg, self.steps_per_epoch,
                                      model.parameters())
        return TrainState(0, model, optimizer)

    def load_weights(self, state: TrainState, params: dict[str, Tensor],
                     batch_stats: dict[str, Tensor] | None = None) -> None:
        """Set the model's parameters (and ranger's slow weights) to
        ``params``, and its BatchNorm statistics to ``batch_stats``, by
        state-dict name; names not given keep their values."""
        names = dict(state.model.named_parameters())
        slow = (dict(zip(names, state.optimizer.slow_params()))
                if isinstance(state.optimizer, Lookahead) else {})
        with torch.no_grad():
            for k, v in params.items():
                names[k].copy_(v)
                if k in slow:
                    slow[k].copy_(v)
            buffers = dict(state.model.named_buffers())
            for k, v in (batch_stats or {}).items():
                buffers[k].copy_(v)

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
        if self.dtype == self.param_dtype:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def device_batch(self, batch: dict) -> dict:
        """numpy batch -> tensors on the trainer's device."""
        return to_device(batch, self.device, self.param_dtype)

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
            outs = (self.replica or model)(*model_batch_args(batch),
                                           cost_volume=self.cost_volume)
        loss = sl1_loss(outs, batch["depths"], batch["masks"], self.levels,
                        self.distributed)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.step += 1
        means = batch_means(outs["depth_0"].detach(),
                            batch["depths"]["level_0"],
                            batch["masks"]["level_0"], self.distributed)
        # each rank's loss is its share of the global one times N
        logs = {"train/loss": all_reduce_sum(loss.detach()) / self.world}
        logs.update({f"train/{k}": v for k, v in means.items()})
        logs["lr"] = lr
        return state, logs

    def eval_forward(self, state: TrainState, batch: dict) -> dict:
        """Eval-mode forward (running statistics; ranger's slow weights) of
        this rank's rows, with no collective."""
        model = state.model
        model.eval()
        args = model_batch_args(batch)
        with torch.no_grad(), self._autocast():
            if isinstance(state.optimizer, Lookahead):
                return torch.func.functional_call(
                    model, self.model_params(state), args,
                    {"cost_volume": self.cost_volume})
            return model(*args, cost_volume=self.cost_volume)

    def val_step(self, state: TrainState,
                 batch: dict) -> tuple[dict, dict]:
        """:meth:`eval_forward`; returns the metric sums of this rank's rows
        with ``loss`` (this rank's share of the global batch's loss times
        N, several ranks), and the outputs."""
        outs = self.eval_forward(state, batch)
        loss = sl1_loss(outs, batch["depths"], batch["masks"], self.levels,
                        self.distributed)
        sums = metric_sums(outs["depth_0"], batch["depths"]["level_0"],
                           batch["masks"]["level_0"])
        sums["loss"] = loss
        return sums, outs

    # -- loops -------------------------------------------------------------
    def _prefetch(self, loader: Iterable) -> Iterator[dict]:
        for batch in prefetch_to_device(iter(loader), self.device,
                                        float_dtype=self.param_dtype):
            batch.pop("scan_vid", None)
            yield batch

    def validate(self, state: TrainState, val_loader: Iterable,
                 epoch: int = 0, global_step: int = 0) -> dict[str, float]:
        if self.distributed:
            # every batch's loss all-reduces its mask count: a rank with
            # fewer batches would leave the others waiting
            check_same_on_ranks(len(val_loader), "validation batch counts",
                                self.device)
        totals: dict[str, Tensor] = {}
        n_batches = 0
        for batch in self._prefetch(val_loader):
            sums, outs = self.val_step(state, batch)
            for k, v in sums.items():       # summed on the device
                totals[k] = totals.get(k, 0.0) + v.double()
            if n_batches == 0 and self.writer is not None:
                self._log_images("val", batch, outs, global_step)
            n_batches += 1
        totals = {k: float(v) for k, v in all_reduce_dict(totals).items()}
        mask_sum = max(totals.get("mask_sum", 0.0), 1.0)
        metrics = {
            "val/loss": totals.get("loss", 0.0) / self.world
            / max(n_batches, 1),
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
            progress: bool = True, first_epoch: int = 0) -> TrainState:
        """``num_epochs`` epochs, numbered from ``first_epoch`` (a resumed
        run's checkpoints continue the numbering)."""
        lead = self.rank == 0
        for epoch in range(first_epoch, first_epoch + num_epochs):
            t0 = time.time()
            iterator = self._prefetch(train_loader)
            if progress and lead:
                from tqdm import tqdm
                iterator = tqdm(iterator, desc=f"epoch {epoch}",
                                total=len(train_loader), leave=False)
            iterator = iter(iterator)
            batch_nb = 0
            while True:
                t_wait = time.perf_counter()
                batch = next(iterator, None)
                if batch is None:
                    break
                t_step = time.perf_counter()
                state, logs = self.train_step(state, batch)
                if self.writer is not None and (state.step % log_every == 0
                                                or batch_nb == 0):
                    for k, v in logs.items():
                        self.writer.add_scalar(k, float(v), state.step)
                if batch_nb == 0 and self.writer is not None:
                    self._log_images("train", batch,
                                     self.eval_forward(state, batch),
                                     state.step)
                if self.step_times is not None:
                    loss = float(logs["train/loss"])    # waits for the step
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.step_times.append({
                        "wait_s": t_step - t_wait, "loss": loss,
                        "step_s": time.perf_counter() - t_wait})
                batch_nb += 1
            metrics = self.validate(state, val_loader, epoch, state.step)
            self.epoch_metrics.append(metrics)
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.save(self.checkpoint_tree(state), metrics,
                                   epoch)
            if self.ckpt_dir and lead:
                save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"),
                                self.checkpoint_tree(state))
            barrier()           # every rank sees the checkpoints
            if lead:
                print(f"epoch {epoch}: " +
                      " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                      + f" ({time.time() - t0:.1f}s)", flush=True)
        return state

    # -- logging -----------------------------------------------------------
    def _log_images(self, tag: str, batch: dict, outs: dict,
                    step: int) -> None:
        """The [image | GT | pred | prob] panel of the batch's first row,
        as the JAX trainer's ``_log_images``."""
        def host(t):
            return t[0].float().cpu().numpy()

        img = unnormalize_image(batch["imgs"][0, 0].cpu().numpy())
        mask = host(batch["masks"]["level_0"])
        gt = visualize_depth(host(batch["depths"]["level_0"]))
        pred = visualize_depth(host(outs["depth_0"]) * mask)
        prob = visualize_prob(host(outs["confidence_0"]) * mask)
        panel = np.concatenate([img, gt, pred, prob], axis=1)  # (H, 4W, 3)
        self.writer.add_image(f"{tag}/image_GT_pred_prob",
                              panel.transpose(2, 0, 1), step)
