"""Optimizer and learning-rate schedule factories.

Counterpart of ``casmvsnet_pl_tpu/utils/optimizers.py`` (optax there):
sgd (momentum), adam, radam and ranger (RAdam + Lookahead); steplr, cosine
and poly schedules with gradual warmup for sgd and adam. Schedules are
evaluated per optimization step from ``steps_per_epoch``, as in the JAX
package. Weight decay is additive L2 on the gradient (torch's
``weight_decay``, optax's ``add_decayed_weights`` before the optimizer),
not decoupled.

sgd and adam are ``torch.optim.SGD`` / ``torch.optim.Adam``, whose steps
equal optax's to rounding. RAdam is written here: optax computes the
rectification's rho_t in float32, where it cancels badly (rho_6 is 5.955
there against 5.994 in float64), and the reference's updates follow
optax's value, so this one computes rho_t the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

import torch


@dataclasses.dataclass
class OptimConfig:
    optimizer: str = "sgd"            # sgd | adam | radam | ranger
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-5
    lr_scheduler: str = "steplr"      # steplr | cosine | poly
    num_epochs: int = 16
    # warmup (applied for sgd/adam only, like the reference)
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    # steplr
    decay_step: Sequence[int] = (20,)
    decay_gamma: float = 0.1
    # poly
    poly_exp: float = 0.9
    eps: float = 1e-8


def make_lr_schedule(cfg: OptimConfig,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Epoch-piecewise schedule evaluated per optimization step."""
    def base_lr_at(epoch: float) -> float:
        if cfg.lr_scheduler == "steplr":
            factor = 1.0
            for milestone in cfg.decay_step:
                if epoch >= milestone:
                    factor *= cfg.decay_gamma
            return cfg.lr * factor
        t = min(max(epoch / cfg.num_epochs, 0.0), 1.0)
        if cfg.lr_scheduler == "cosine":
            eta_min = cfg.eps
            return eta_min + (cfg.lr - eta_min) * 0.5 * (1 + math.cos(math.pi
                                                                      * t))
        if cfg.lr_scheduler == "poly":
            return cfg.lr * (1 - t) ** cfg.poly_exp
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")

    base_lr_at(0.0)                   # reject an unknown scheduler now
    warmup_on = (cfg.warmup_epochs > 0 and cfg.optimizer in ("sgd", "adam")
                 and cfg.warmup_multiplier >= 1.0)

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if not warmup_on:
            return base_lr_at(epoch)
        # GradualWarmupScheduler: base_lr -> base_lr * multiplier over
        # warmup_epochs, then the wrapped schedule, shifted, with its base
        # lr scaled by the multiplier.
        if epoch <= cfg.warmup_epochs:
            return cfg.lr * ((cfg.warmup_multiplier - 1.0)
                             * epoch / cfg.warmup_epochs + 1.0)
        return cfg.warmup_multiplier * base_lr_at(epoch - cfg.warmup_epochs)

    return schedule


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as optax's ``radam`` (threshold 5, eps outside the
    square root, L2 weight decay on the gradient)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      threshold=threshold))

    @staticmethod
    def _rho(b2: float, t: int) -> float:
        """optax's rho_t, in float32 as optax computes it."""
        f32 = torch.float32
        tt = torch.tensor(float(t), dtype=f32)
        b2t = torch.tensor(b2, dtype=f32) ** tt
        ro_inf = torch.tensor(2.0 / (1.0 - b2) - 1.0, dtype=f32)
        return float(ro_inf - 2 * tt * b2t / (1 - b2t))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = mu / (1 - b1 ** t)
                ro = self._rho(b2, t)
                if ro >= group["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    nu_hat = nu / (1 - b2 ** t)
                    upd = mu_hat.mul_(r).div_(nu_hat.sqrt_().add_(
                        group["eps"]))
                else:
                    upd = mu_hat
                p.add_(upd, alpha=-group["lr"])
        return None


class Lookahead:
    """Lookahead around an inner optimizer, as optax's ``lookahead``: the
    model holds the fast weights that the inner optimizer steps; every
    ``sync_period`` steps the slow weights move ``slow_step_size`` of the
    way to the fast ones and the fast weights are reset to them."""

    def __init__(self, inner: torch.optim.Optimizer, sync_period: int = 6,
                 slow_step_size: float = 0.5):
        self.inner = inner
        self.param_groups = inner.param_groups
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.slow = [p.detach().clone() for p in self._params()]
        self.steps_since_sync = 0

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        if self.steps_since_sync == self.sync_period - 1:
            for s, f in zip(self.slow, self._params()):
                s.add_(f - s, alpha=self.slow_step_size)
                f.copy_(s)
        self.steps_since_sync = (self.steps_since_sync + 1) % self.sync_period

    def slow_params(self) -> list[torch.Tensor]:
        """The slow weights, in the order of the inner optimizer's params."""
        return self.slow

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "slow": list(self.slow),
                "steps_since_sync": self.steps_since_sync}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        with torch.no_grad():
            for s, v in zip(self.slow, state["slow"]):
                s.copy_(v)
        self.steps_since_sync = int(state["steps_since_sync"])


def make_optimizer(cfg: OptimConfig, steps_per_epoch: int,
                   params: Iterable[torch.Tensor]):
    """(optimizer, schedule). The caller sets each param group's ``lr`` to
    ``schedule(step)`` before step ``step`` (0-based), as optax does."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    params = list(params)
    lr, wd = schedule(0), cfg.weight_decay
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                              weight_decay=wd)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, eps=cfg.eps, weight_decay=wd)
    elif cfg.optimizer == "radam":
        opt = RAdam(params, lr=lr, eps=cfg.eps, weight_decay=wd)
    elif cfg.optimizer == "ranger":
        opt = Lookahead(RAdam(params, lr=lr, eps=cfg.eps, weight_decay=wd),
                        sync_period=6, slow_step_size=0.5)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, schedule


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
