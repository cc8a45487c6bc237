"""The port's main paths in one call each: inference and training.

``entry`` is the counterpart of ``__graft_entry__.py::entry``: the cascade
inference forward. ``train_entry`` is the counterpart of
``scripts/profile_train_step.py``: a trainer, its state and a batch at the
reference training protocol (B=2, Adam, lr 1e-3). Both build
``CascadeMVSNet`` at its default config (n_depths 8/32/48, interval ratios
1/2/4, variance cost volume, sampling "auto") on synthetic plane scenes at
640x512 with 3 views, with weights drawn from a seeded ``torch.Generator``;
``sampling`` and ``num_groups`` pick another configuration of the model, as
``train.py``'s and ``eval.py``'s ``--sampling`` and ``--num_groups`` do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .data.loader import collate
from .data.synthetic import PlaneScene
from .engine.trainer import MVSTrainer
from .models import CascadeMVSNet
from .utils.optimizers import OptimConfig

DEPTH_MIN = 425.0
DEPTH_INTERVAL = 2.65


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv weights (std 1/sqrt(fan_in), as the JAX package's
    flax convs), zero conv biases; BN keeps its identity statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def make_inputs(batch: int, img_wh=(640, 512), n_views: int = 3,
                device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Plane-scene images (B, V, H, W, 3) and projections (B, V-1, 3, 3, 4),
    float32, with the rig of ``bench.py::make_inputs``."""
    scene = PlaneScene(img_wh=tuple(img_wh), n_views=n_views, z0=460.0,
                       baseline=12.0, focal=600.0, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    imgs = torch.from_numpy(imgs).to(device).repeat(batch, 1, 1, 1, 1)
    proj = torch.from_numpy(proj).to(device).repeat(batch, 1, 1, 1, 1)
    return imgs, proj


def entry(device="cuda", dtype: torch.dtype | None = None, batch: int = 1,
          img_wh=(640, 512), seed: int = 0, sampling: str = "auto",
          num_groups: int = 1):
    """(fn, args): ``fn(*args)`` runs the inference forward and returns
    ``(depth_0 (B, H, W), confidence_2 (B, H/4, W/4))``.

    ``dtype`` is the compute dtype of features and convolutions: bf16 on a
    CUDA device and f32 on the CPU unless given. ``fn`` takes an optional
    ``cost_volume`` in place of the model's own (``build_cost_volume`` with
    its ``sampling``).
    """
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = CascadeMVSNet(num_groups=num_groups, sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    imgs, proj_mats = make_inputs(batch, img_wh, device=device)

    def fn(model, imgs, proj_mats, cost_volume=None):
        with torch.inference_mode():
            out = model(imgs, proj_mats, DEPTH_MIN, DEPTH_INTERVAL,
                        cost_volume=cost_volume)
        return out["depth_0"], out["confidence_2"]

    return fn, (model, imgs, proj_mats)


def plane_sample(i: int, img_wh=(640, 512)) -> dict:
    """Training sample ``i``: a 3-view plane scene of its own (depth, slope
    and texture vary with i) with the rig of ``bench.py::make_inputs``,
    focal length scaled with the width. numpy arrays: imgs (V, H, W, 3),
    proj_mats (V-1, 3, 3, 4), the depth range, and depth and mask
    pyramids {'level_l': (H/2^l, W/2^l)}."""
    scene = PlaneScene(img_wh=tuple(img_wh), n_views=3,
                       z0=460.0 + 8.0 * i, baseline=12.0,
                       focal=600.0 * img_wh[0] / 640, slope_x=0.2 - 0.05 * i,
                       seed=i)
    imgs, proj, depths = scene.model_inputs()
    return {"imgs": imgs[0], "proj_mats": proj[0],
            "init_depth_min": np.float32(DEPTH_MIN),
            "depth_interval": np.float32(DEPTH_INTERVAL),
            "depths": {k: v[0] for k, v in depths.items()},
            "masks": {k: np.ones(v[0].shape, bool) for k, v in depths.items()}}


def train_entry(device="cuda", dtype: torch.dtype | None = None,
                batch: int = 2, img_wh=(640, 512), optimizer: str = "adam",
                seed: int = 0, n_depths=(8, 32, 48), lr: float = 1e-3,
                steps_per_epoch: int = 100, optim_kwargs: dict | None = None,
                cost_volume=None, sampling: str = "auto",
                num_groups: int = 1, **trainer_kwargs):
    """(trainer, state, batch): ``trainer.train_step(state, batch)`` runs one
    training step of ``CascadeMVSNet`` on ``batch`` plane scenes
    (:func:`plane_sample` 0..batch-1, already on the device).

    ``dtype`` is the compute dtype (bf16 on a CUDA device and f32 on the
    CPU unless given); parameters stay float32. The optimizer is
    ``OptimConfig(optimizer, lr, **optim_kwargs)``. ``cost_volume``
    replaces the model's own (``build_cost_volume`` with ``sampling``);
    other keyword arguments go to :class:`MVSTrainer` (``ckpt_dir``,
    ``log_dir``, ...).
    """
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = CascadeMVSNet(n_depths=n_depths, num_groups=num_groups,
                          sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(seed))
    cfg = OptimConfig(optimizer=optimizer, lr=lr, **(optim_kwargs or {}))
    trainer = MVSTrainer(model, cfg, steps_per_epoch, device=device,
                         dtype=dtype, cost_volume=cost_volume,
                         **trainer_kwargs)
    state = trainer.init_state()
    data = collate([plane_sample(i, img_wh) for i in range(batch)])
    return trainer, state, trainer.device_batch(data)
