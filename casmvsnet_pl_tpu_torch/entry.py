"""The port's main paths in one call each: inference and training.

``entry`` is the counterpart of ``__graft_entry__.py::entry``: the cascade
inference forward. ``train_entry`` is the counterpart of
``scripts/profile_train_step.py``: a trainer, its state and a batch at the
reference training protocol (B=2, Adam, lr 1e-3); in a process group it
gives this rank's rows of the global batch. ``data_parallel_step`` runs
one step of it as one rank of several and saves what the step did. All
build
``CascadeMVSNet`` at its default config (n_depths 8/32/48, interval ratios
1/2/4, variance cost volume, sampling "auto") on synthetic plane scenes at
640x512 with 3 views, with weights drawn from a seeded ``torch.Generator``;
``sampling`` and ``num_groups`` pick another configuration of the model, as
``train.py``'s and ``eval.py``'s ``--sampling`` and ``--num_groups`` do;
``entry``'s ``arch`` builds ``TransMVSNet`` in its place, as
``eval_torch.py --arch transmvsnet`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .data.loader import collate
from .data.synthetic import PlaneScene
from .engine.trainer import MVSTrainer
from .models import build_model
from .models.transmvsnet import DeformConv2d
from .parallel import rank, shard_batch, world_size
from .utils.optimizers import OptimConfig

DEPTH_MIN = 425.0
DEPTH_INTERVAL = 2.65


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv weights (std 1/sqrt(fan_in), as the JAX package's
    flax convs), zero conv biases; BN keeps its identity statistics. In
    TransMVSNet also the deformable convs' and the Linear layers' weights
    (LayerNorm stays the identity)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (DeformConv2d, nn.Linear)):
                fan_in = math.prod(m.weight.shape[1:])
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)


def make_inputs(batch: int, img_wh=(640, 512), n_views: int = 3,
                device="cpu", focal: float = 600.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plane-scene images (B, V, H, W, 3) and projections (B, V-1, 3, 3, 4),
    float32, with the rig of ``bench.py::make_inputs`` (``focal`` 1000 is
    ``scripts/profile_eval_res.py``'s)."""
    scene = PlaneScene(img_wh=tuple(img_wh), n_views=n_views, z0=460.0,
                       baseline=12.0, focal=focal, slope_x=0.2)
    imgs, proj, _ = scene.model_inputs()
    imgs = torch.from_numpy(imgs).to(device).repeat(batch, 1, 1, 1, 1)
    proj = torch.from_numpy(proj).to(device).repeat(batch, 1, 1, 1, 1)
    return imgs, proj


def entry(device="cuda", dtype: torch.dtype | None = None, batch: int = 1,
          img_wh=(640, 512), seed: int = 0, sampling: str = "auto",
          num_groups: int = 1, n_views: int = 3, focal: float = 600.0,
          arch: str = "casmvsnet"):
    """(fn, args): ``fn(*args)`` runs the inference forward and returns
    ``(depth_0 (B, H, W), confidence_2 (B, H/4, W/4))``.

    ``dtype`` is the compute dtype of features and convolutions: bf16 on a
    CUDA device and f32 on the CPU unless given. ``n_views`` and ``focal``
    are the plane scene's (:func:`make_inputs`). ``fn`` takes an optional
    ``cost_volume`` in place of the model's own (``build_cost_volume`` with
    its ``sampling``).
    """
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_model(arch, num_groups=num_groups, sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    imgs, proj_mats = make_inputs(batch, img_wh, n_views, device, focal)

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
                num_groups: int = 1, arch: str = "casmvsnet",
                **trainer_kwargs):
    """(trainer, state, batch): ``trainer.train_step(state, batch)`` runs one
    training step of ``CascadeMVSNet`` (``arch``: the model of
    ``models.build_model``, with its own objective) on ``batch`` plane scenes
    (:func:`plane_sample` 0..batch-1, already on the device; in a process
    group, this rank's rows of them).

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
    model = build_model(arch, n_depths, num_groups=num_groups,
                        sampling=sampling)
    init_weights(model, torch.Generator().manual_seed(seed))
    cfg = OptimConfig(optimizer=optimizer, lr=lr, **(optim_kwargs or {}))
    trainer = MVSTrainer(model, cfg, steps_per_epoch, device=device,
                         dtype=dtype, cost_volume=cost_volume,
                         **trainer_kwargs)
    state = trainer.init_state()
    data = collate([plane_sample(i, img_wh) for i in range(batch)])
    data = shard_batch(data, rank(), world_size())
    return trainer, state, trainer.device_batch(data)


def data_parallel_step(rank_: int, world: int, device: torch.device,
                       spec: dict) -> None:
    """One SGD step (no momentum, no weight decay) of the data-parallel
    trainer as rank ``rank_`` of ``world`` on ``device``, in a process
    group already joined (``parallel/dist.py::spawn`` passes the first
    three arguments). ``spec``: ``batch`` (the global batch, a numpy batch
    dict, or a row count of :func:`plane_sample`), ``img_wh``,
    ``n_depths``, ``lr``, ``seed``; ``dtype`` (float32 unless given:
    float64 is a reference on the CPU); ``weights`` (a state dict to start
    from, else the seed's); ``deterministic`` (cuDNN's deterministic
    algorithms); ``out`` (a path prefix). Saves to ``<out>.<rank>`` the
    logged loss, every parameter's gradient and every buffer, on the CPU,
    and the kernels' launches during the step."""
    from . import kernels
    torch.backends.cudnn.deterministic = spec.get("deterministic", False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    global_batch = spec["batch"]
    n = global_batch if isinstance(global_batch, int) else \
        len(global_batch["imgs"])
    trainer, state, batch = train_entry(
        device, spec.get("dtype", torch.float32), batch=n,
        img_wh=tuple(spec["img_wh"]),
        optimizer="sgd", lr=spec["lr"], seed=spec.get("seed", 0),
        n_depths=tuple(spec["n_depths"]),
        optim_kwargs=dict(momentum=0.0, weight_decay=0.0))
    if not isinstance(global_batch, int):
        batch = trainer.device_batch(shard_batch(global_batch, rank_, world))
    if spec.get("weights") is not None:
        state.model.load_state_dict(spec["weights"], strict=True)
    launches = kernels.launch_counts()
    state, logs = trainer.train_step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    torch.save({
        "loss": float(logs["train/loss"]),
        "logs": {k: float(v) for k, v in logs.items()},
        "grads": {k: p.grad.detach().cpu() for k, p in
                  state.model.named_parameters()},
        "buffers": {k: b.detach().cpu() for k, b in
                    state.model.named_buffers()},
        "launches": {n: c - launches[n] for n, c in
                     kernels.launch_counts().items()}},
        f"{spec['out']}.{rank_}")
