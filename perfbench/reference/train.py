"""The reference's training steps: the loss, Adam, and what is compared.

The loss is the reference repository's ``losses.py``: per level a SmoothL1
(beta 1) between depth and ground truth, averaged over the masked pixels,
weighted 2^(1-l) (2, 1, 0.5 fine to coarse). Adam is the published
algorithm with L2 weight decay added to the gradient (the reference
repository's ``torch.optim.Adam(weight_decay=...)``), bias-corrected,
eps outside the square root.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import CascadeMVSNet

Tensor = torch.Tensor
BETAS = (0.9, 0.999)
EPS = 1e-8


def sl1_loss(out: dict, depths: dict, masks: dict, levels: int) -> Tensor:
    loss = 0.0
    for l in range(levels):
        m = masks[f"level_{l}"]
        err = F.smooth_l1_loss(out[f"depth_{l}"][m], depths[f"level_{l}"][m],
                               reduction="mean", beta=1.0)
        loss = loss + err * 2.0 ** (1 - l)
    return loss


class Adam:
    def __init__(self, params: list[Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> list[Tensor]:
        """Update; returns the gradients as the update took them (with the
        weight decay)."""
        self.t += 1
        b1, b2 = BETAS
        taken = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            taken.append(g.clone())
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(EPS)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))
        return taken


def train_steps(config: dict, weights: dict, batches: list[dict],
                quant: str | None = None) -> dict:
    """Run the reference's training steps from ``weights`` over
    ``batches`` (one step each). Returns ``losses`` (one float a step),
    ``grads`` (the first step's gradients as Adam took them, by parameter
    name), ``raw_grads`` (the first step's loss gradients, by name) and
    ``change`` (the parameters after the last step minus ``weights``)."""
    device = next(iter(weights.values())).device
    model = CascadeMVSNet(config).to(device)
    model.load_state_dict(weights, strict=True)
    model.set_quant(quant)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = Adam(params, config["lr"], config["weight_decay"])
    losses, grads, raw = [], None, None
    for batch in batches:
        for p in params:
            p.grad = None
        out = model(batch["imgs"], batch["proj_mats"],
                    batch["init_depth_min"], batch["depth_interval"])
        loss = sl1_loss(out, batch["depths"], batch["masks"],
                        config["levels"])
        loss.backward()
        losses.append(float(loss.detach()))
        if raw is None:
            raw = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        taken = opt.step()
        if grads is None:
            grads = dict(zip(names, taken))
    change = {n: (p.detach() - weights[n]) for n, p in zip(names, params)}
    return {"losses": losses, "grads": grads, "raw_grads": raw,
            "change": change}
