"""Training with the PyTorch port, on one NVIDIA GPU or several.

The port's counterpart of ``train.py``, with its flags
(``casmvsnet_pl_tpu_torch/opt.py``) and outputs: top-k checkpoints on
val/acc_2mm and ``last.ckpt`` under ``ckpts/<exp_name>``, TensorBoard
events (scalars and [image|GT|pred|prob] panels) under
``logs/<exp_name>``:

    python train_torch.py --root_dir <DTU training root> --batch_size 2 \\
        --optimizer adam --lr 1e-3 --num_epochs 16

It trains ``CascadeMVSNet`` (``--n_depths``, ``--interval_ratios``,
``--num_groups``, ``--sampling``) at ``--precision`` on the train split of
``--dataset_name``'s reader (DTU, or BlendedMVS at its 768x576, where
``--depth_interval`` is the number of depth hypotheses in all; a warm
start from a DTU checkpoint is ``--ckpt_path``) and validates on its val
split (the last global batch padded
with mask-zeroed rows, so every sample counts). The card is the default;
``--cpu`` trains on the CPU; without a card and without ``--cpu`` it
exits 1.

Data parallelism. ``--batch_size`` is the global batch, as in JAX.
``--num_devices N`` (``--num_gpus``) with N > 1 starts N processes, one a
card (``torch.multiprocessing``, spawn; NCCL; with ``--cpu``, N processes
over gloo), which meet through a file in a temporary directory; each takes
its contiguous rows of every global batch, BatchNorm and the loss are over
the global batch, and rank 0 writes checkpoints, events and prints.
``--num_devices 0`` takes every visible card (one process when there is
one card, or with ``--cpu``). Under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) the ranks are torchrun's.

Flags without a counterpart in the port:
  - ``--remat`` is accepted and does nothing: on the default route K1 and
    K2 keep no warped volume for the backward (K2 recomputes the samples
    from the features), so there is nothing to rematerialize. The quad
    route (``--sampling quad``) does keep its gathered rows (B, V-1, D,
    h*w, 4C) and tap weights for the backward, and ``--remat`` does not
    change that.
  - ``--num_workers`` is the loader's thread count (threads, not
    processes).
"""
from __future__ import annotations

import os
import sys

import torch

from casmvsnet_pl_tpu_torch.data import DataLoader, dataset_dict
from casmvsnet_pl_tpu_torch.engine import MVSTrainer
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.opt import get_opts
from casmvsnet_pl_tpu_torch.parallel import (initialize_distributed,
                                             rank_device, spawn)
from casmvsnet_pl_tpu_torch.utils import (OptimConfig, extract_model_params,
                                          load_checkpoint, partial_load)


def resolve_device(hparams) -> torch.device:
    """The card, or the CPU with ``--cpu``; without a card, exit 1."""
    if hparams.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("train_torch.py: no CUDA device; pass --cpu to "
                         "train on the CPU")
    return torch.device("cuda")


def dataset_class(name: str):
    return dataset_dict[name]


def main(hparams, dataset_cls=None, time_steps: bool = False):
    """Train as ``hparams`` say. ``dataset_cls`` replaces the dataset's
    reader (a subclass for another tree layout; it must pickle when
    several processes train); ``time_steps`` records each train step's
    wall time, loader wait and loss in the trainer's ``step_times``.
    Returns (trainer, state) in a single process, None after spawning
    ranks."""
    device = resolve_device(hparams)
    dataset_cls = dataset_cls or dataset_class(hparams.dataset_name)
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = rank_device(local, hparams.cpu)
        initialize_distributed(rank, world, "env://", device=device)
        try:
            return train(hparams, dataset_cls, device, time_steps)
        finally:
            torch.distributed.destroy_process_group()
    world = hparams.num_devices or (
        torch.cuda.device_count() if device.type == "cuda" else 1)
    if hparams.batch_size % world:
        raise ValueError(f"--batch_size {hparams.batch_size} is not "
                         f"divisible by the {world} processes")
    if world == 1:
        return train(hparams, dataset_cls, device, time_steps)
    spawn(_rank_main, world, (hparams, dataset_cls, time_steps),
          cpu=hparams.cpu)
    return None


def _rank_main(rank, world, device, hparams, dataset_cls, time_steps):
    train(hparams, dataset_cls, device, time_steps)


def train(hparams, dataset_cls, device, time_steps: bool = False):
    """One process's training: the whole run, or its rank's share."""
    from casmvsnet_pl_tpu_torch.parallel import rank, world_size
    r, world = rank(), world_size()
    lead = r == 0
    dtype = torch.bfloat16 if hparams.precision == "bf16" or \
        hparams.use_amp else torch.float32
    model = CascadeMVSNet(n_depths=tuple(hparams.n_depths),
                          interval_ratios=tuple(hparams.interval_ratios),
                          num_groups=hparams.num_groups,
                          sampling=hparams.sampling)
    init_weights(model, torch.Generator().manual_seed(hparams.seed))

    kw = dict(n_views=hparams.n_views, levels=hparams.levels,
              depth_interval=hparams.depth_interval)
    train_ds = dataset_cls(hparams.root_dir, "train", **kw)
    val_ds = dataset_cls(hparams.root_dir, "val", **kw)
    train_loader = DataLoader(train_ds, hparams.batch_size, shuffle=True,
                              num_workers=hparams.num_workers,
                              seed=hparams.seed, rank=r, world=world)
    # pad+mask instead of drop_last: every val sample counts (the padded
    # rows carry zeroed masks, invisible to the pixel-weighted sums)
    val_loader = DataLoader(val_ds, hparams.batch_size, shuffle=False,
                            drop_last=False, pad_last=True,
                            num_workers=hparams.num_workers, rank=r,
                            world=world)

    cfg = OptimConfig(
        optimizer=hparams.optimizer, lr=hparams.lr,
        momentum=hparams.momentum, weight_decay=hparams.weight_decay,
        lr_scheduler=hparams.lr_scheduler, num_epochs=hparams.num_epochs,
        warmup_multiplier=hparams.warmup_multiplier,
        warmup_epochs=hparams.warmup_epochs,
        decay_step=tuple(hparams.decay_step),
        decay_gamma=hparams.decay_gamma, poly_exp=hparams.poly_exp)
    trainer = MVSTrainer(model, cfg, steps_per_epoch=len(train_loader),
                         device=device, dtype=dtype,
                         ckpt_dir=os.path.join("ckpts", hparams.exp_name),
                         log_dir=os.path.join("logs", hparams.exp_name),
                         levels=hparams.levels, time_steps=time_steps)

    if hparams.resume_path:
        if lead:
            print("Resume full training state from", hparams.resume_path)
        state = trainer.restore_state(hparams.resume_path)
    else:
        state = trainer.init_state()

    if lead:
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"number of parameters : {n_params / 1e6:.2f} M "
              f"on {world} device(s)")

    if hparams.ckpt_path:
        if lead:
            print("Load model from", hparams.ckpt_path)
        ckpt = load_checkpoint(hparams.ckpt_path)
        new_params, _, skipped = partial_load(
            trainer.model_params(state), extract_model_params(ckpt),
            tuple(hparams.prefixes_to_ignore))
        if lead:
            for k in skipped:
                print("ignore", k)
        # BatchNorm statistics: all of the checkpoint's, as in JAX, where
        # the model has them at the same shape
        stats, _, _ = partial_load(dict(state.model.named_buffers()),
                                   ckpt.get("batch_stats", {}))
        trainer.load_weights(state, new_params, stats)

    # a resumed run goes on with the epochs (and the shuffled order) of an
    # uninterrupted one
    first_epoch = state.step // max(len(train_loader), 1)
    train_loader.skip_epochs(first_epoch)
    state = trainer.fit(state, train_loader, val_loader, hparams.num_epochs,
                        progress=lead, first_epoch=first_epoch)
    return trainer, state


if __name__ == "__main__":
    main(get_opts())
    sys.exit(0)
