"""The system under test, built from a configuration and the seed's weights.

This module is the benchmark's only door into the port
(``casmvsnet_pl_tpu_torch``): the model, the eval call as
``eval_torch.py::Predictor`` makes it, and the trainer as
``entry.py::train_entry`` builds it. The port is imported inside the
functions, so that importing the harness loads none of it.

The weights are the benchmark's: one draw on the device from the seed
(:func:`draw_weights`), handed to the program and, kept aside, to the
reference. Convolution weights are Kaiming-normal (deviation
sqrt(2 / fan_in), fan_in the input channels times the taps), as trained
networks keep their activations at unit scale; biases are zero, BatchNorm
is the identity (weight 1, bias 0, running mean 0, variance 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from perfbench.reference.model import CascadeMVSNet as RefModel
from perfbench.reference.model import QConvTranspose3d


def draw_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict (reference names, float32, on ``device``) of the
    seed's weights: every convolution weight from one normal draw."""
    ref = RefModel(config)
    state = {k: v.to(device) for k, v in ref.state_dict().items()}
    convs = [(name, m) for name, m in ref.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d))]
    total = sum(m.weight.numel() for _, m in convs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    z = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, m in convs:
        w = state[f"{name}.weight"]
        cin = w.shape[0] if isinstance(m, QConvTranspose3d) else w.shape[1]
        fan_in = cin * math.prod(m.kernel_size)
        w.copy_(z[at:at + w.numel()].view_as(w) * math.sqrt(2.0 / fan_in))
        at += w.numel()
    return state


def port_model(config: dict, weights: dict, device, dtype=None):
    """The port's ``CascadeMVSNet`` of ``config`` with ``weights``, on
    ``device`` (its parameters in ``dtype`` if given)."""
    from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
    model = CascadeMVSNet(n_depths=tuple(config["n_depths"]),
                          interval_ratios=tuple(config["interval_ratios"]),
                          num_groups=config["num_groups"], sampling="auto")
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    return model.to(dtype=dtype)


def predictor(config: dict, weights: dict, device):
    """The eval entry: ``eval_torch.py::Predictor`` over the model in the
    configuration's precision, in eval mode. ``predict(imgs, proj,
    init_depth_min, depth_interval)`` returns (depth_0, confidence_2)."""
    from eval_torch import Predictor
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[
        config["precision"]]
    return Predictor(port_model(config, weights, device, dtype).eval(),
                     torch.device(device))


def trainer(config: dict, weights: dict, device, steps_per_epoch: int = 100):
    """(trainer, state) as ``entry.py::train_entry`` builds them: the
    configuration's optimizer and learning rate, float32 parameters and
    autocast in the configuration's precision on the card (float32 on the
    CPU, where autocast has no bf16 convolutions worth testing); in a
    process group, ``DistributedDataParallel`` and SyncBN."""
    from casmvsnet_pl_tpu_torch.engine.trainer import MVSTrainer
    from casmvsnet_pl_tpu_torch.utils.optimizers import OptimConfig
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" and \
        config["precision"] == "bf16" else torch.float32
    model = port_model(config, weights, device)
    cfg = OptimConfig(optimizer=config["optimizer"], lr=config["lr"],
                      weight_decay=config["weight_decay"])
    tr = MVSTrainer(model, cfg, steps_per_epoch, device=device, dtype=dtype)
    return tr, tr.init_state()


def launch_counts() -> dict[str, int]:
    """The port's kernels' launch counters by name."""
    from casmvsnet_pl_tpu_torch import kernels
    return {n: getattr(kernels, n).launches for n in dir(kernels)
            if n.endswith("_cuda")}


def build_kernels() -> float:
    """Build (or load from ``_build/``) the port's kernel library; seconds."""
    import time
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda
    t0 = time.perf_counter()
    cost_volume_cuda.build()
    return time.perf_counter() - t0
