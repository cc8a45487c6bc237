"""TransMVSNet's reference training step: its focal loss, Adam, and what is
compared.

The forward is ``reference/transmvsnet.py``'s model (plain PyTorch,
float32, no kernel and nothing of the port), run by
:class:`TrainingTransMVSNet` with three changes of bookkeeping and none of
arithmetic:
  - each level returns its hypotheses ``depth_values_l`` beside its
    probability volume, rebuilt from the coarser level's depth with
    ``reference/model.py::depth_window``, and its cost volume
    ``volume_l`` as the regularization takes it;
  - each deformable conv and each depth chunk of the correlation is
    recomputed in the backward (``torch.utils.checkpoint``), so that a step
    at 640x512 with 5 views holds a few GB of samples, not tens;
  - the windows of levels 1 and 0 may be centred on given depths (the
    program's detached winner-take-all depths of the same step) in place
    of the reference's own: winner-take-all on near-uniform probabilities
    flips between bf16 and float32, and a flipped centre moves a window.

The loss, written from the paper (Ding et al., arXiv:2111.14600) and
independently of the port's ``losses.py``: per level l, the one-hot of the
hypothesis nearest the ground truth (``argmin``, the first of a tie), the
probability it selects P, and the mean over the level's masked pixels of
-(1 - P)^gamma log(P + eps), weighted lambda_l and summed; gamma, the
weights and eps from the configuration (``gamma``, ``loss_weights``,
``log_eps``). Adam and its betas are ``reference/train.py``'s, and
``set_quant`` gives the fp8 control as for the other cells.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.model import depth_window, q
from perfbench.reference.train import Adam
from perfbench.reference.transmvsnet import (ARF, CHANNELS, TransMVSNet,
                                             correlation)

Tensor = torch.Tensor
CHUNK = 8                       # depths a recomputed correlation chunk


class _RecomputedARF(ARF):
    """ARF with each deformable conv recomputed in the backward."""

    def forward(self, x):
        def dcn(m, t):
            return checkpoint(m, t, use_reentrant=False)
        x = F.relu(self.bn0(dcn(self.dcn0, x)))
        x = F.relu(self.bn1(dcn(self.dcn1, x)))
        return dcn(self.dcn2, x)


class TrainingTransMVSNet(TransMVSNet):
    """The reference TransMVSNet for training steps (see the module's
    docstring); parameter and buffer names are the reference's."""

    def __init__(self, config: dict):
        super().__init__(config)
        self.arf = nn.ModuleList(_RecomputedARF(c) for c in CHANNELS)
        self.set_quant(None)

    def forward(self, imgs: Tensor, proj: Tensor, depth_min: Tensor,
                depth_interval: Tensor, centres: dict | None = None
                ) -> dict[str, Tensor]:
        """As ``TransMVSNet.forward``, and ``depth_values_l`` and
        ``volume_l`` (B, D_l, h_l, w_l, detached). ``centres`` {l: (B, h_l, w_l)}: the depth of level l on which
        level l - 1's window is centred, in place of the reference's."""
        B = imgs.shape[0]
        feats = self.features(imgs)
        out, prev = {}, None
        for l in reversed(range(self.levels)):
            f = q(feats[l], self.quant)
            h, w = f.shape[-2:]
            D = self.n_depths[l]
            interval = depth_interval * self.ratios[l]
            if prev is None:
                k = torch.arange(D, dtype=torch.float32, device=imgs.device)
                depth = (depth_min[:, None] + interval[:, None] * k)[
                    :, :, None, None].expand(B, D, h, w)
            else:
                centre = prev if centres is None else centres[l + 1]
                up = F.interpolate(centre[:, None], size=(h, w),
                                   mode="bilinear", align_corners=True)[:, 0]
                depth = depth_window(up, D, interval)
            vol = torch.cat([
                checkpoint(correlation, f, proj[:, :, l],
                           depth[:, i:i + CHUNK], CHUNK, use_reentrant=False)
                for i in range(0, D, CHUNK)], 2)
            vol = q(vol, self.quant)
            cost = getattr(self, f"cost_reg_{l}")(vol)
            prob = torch.softmax(cost, 1)
            best, idx = prob.max(1)
            prev = torch.gather(depth, 1, idx[:, None])[:, 0]
            out[f"depth_{l}"] = prev
            out[f"confidence_{l}"] = best
            out[f"prob_{l}"] = prob
            out[f"depth_values_{l}"] = depth
            out[f"volume_{l}"] = vol.detach()[:, 0]
        return out


def focal_loss(out: dict, depths: dict, masks: dict, config: dict) -> Tensor:
    """The configuration's focal loss of ``out`` (see the module's
    docstring)."""
    gamma, eps = config["gamma"], config["log_eps"]
    loss = 0.0
    for l, weight in enumerate(config["loss_weights"]):
        prob = out[f"prob_{l}"]
        gt, m = depths[f"level_{l}"], masks[f"level_{l}"]
        nearest = torch.argmin(
            torch.abs(out[f"depth_values_{l}"] - gt.unsqueeze(1)), dim=1)
        onehot = torch.zeros_like(prob).scatter_(1, nearest.unsqueeze(1), 1.0)
        p = (onehot * prob).sum(1)
        per_pixel = -torch.pow(1.0 - p, gamma) * torch.log(p + eps)
        loss = loss + weight * per_pixel[m].mean()
    return loss


def train_steps(config: dict, weights: dict, batches: list[dict],
                quant: str | None = None, centres: list | None = None
                ) -> dict:
    """The reference's training steps from ``weights`` over ``batches`` (one
    step each), the windows centred on ``centres[j]`` at step j where given
    (:meth:`TrainingTransMVSNet.forward`). Returns what
    ``reference/train.py::train_steps`` returns: ``losses``, ``grads`` (the
    first step's gradients as Adam took them), ``raw_grads`` and
    ``change``, by parameter name; ``centres``: each step's depths
    {l: (B, h_l, w_l)} of levels 1 .. L-1, on which its finer windows were
    centred; of the first step, ``wta``: its own winner-take-all at those
    levels, {l: (depth, lead, interval)}, each (B, h_l, w_l): the depth of
    the largest probability, log(largest / second largest) and the
    window's spacing; and ``volumes``: each level's volume
    {l: (B, D_l, h_l, w_l)}."""
    device = next(iter(weights.values())).device
    model = TrainingTransMVSNet(config).to(device)
    model.load_state_dict(weights, strict=True)
    model.set_quant(quant)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = Adam(params, config["lr"], config["weight_decay"])
    losses, grads, raw, used, wta, volumes = [], None, None, [], None, None
    for j, batch in enumerate(batches):
        for p in params:
            p.grad = None
        out = model(batch["imgs"], batch["proj_mats"],
                    batch["init_depth_min"], batch["depth_interval"],
                    None if centres is None else centres[j])
        used.append(centres[j] if centres is not None else {
            l: out[f"depth_{l}"].detach() for l in range(1, model.levels)})
        if j == 0:
            wta = {l: _winner(out, l) for l in range(1, model.levels)}
            volumes = {l: out[f"volume_{l}"] for l in range(model.levels)}
        loss = focal_loss(out, batch["depths"], batch["masks"], config)
        loss.backward()
        losses.append(float(loss.detach()))
        if raw is None:
            raw = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        taken = opt.step()
        if grads is None:
            grads = dict(zip(names, taken))
    change = {n: (p.detach() - weights[n]) for n, p in zip(names, params)}
    return {"losses": losses, "grads": grads, "raw_grads": raw,
            "change": change, "centres": used, "wta": wta,
            "volumes": volumes}


def first_volumes(config: dict, weights: dict, batch: dict,
                  centres: dict | None = None) -> dict:
    """Each level's volume {l: (B, D_l, h_l, w_l)} of the reference's
    training forward (BatchNorm on the batch's statistics) on ``batch``
    from ``weights``, centred on ``centres`` where given: the first step's
    volumes of :func:`train_steps`, with no backward."""
    device = next(iter(weights.values())).device
    model = TrainingTransMVSNet(config).to(device)
    model.load_state_dict(weights, strict=True)
    model.train()
    with torch.no_grad():
        out = model(batch["imgs"], batch["proj_mats"],
                    batch["init_depth_min"], batch["depth_interval"],
                    centres)
    return {l: out[f"volume_{l}"] for l in range(model.levels)}


def _winner(out: dict, l: int) -> tuple[Tensor, Tensor, Tensor]:
    """Level l's (depth, lead, interval) (see :func:`train_steps`)."""
    with torch.no_grad():
        top = torch.topk(out[f"prob_{l}"], 2, dim=1).values
        hyp = out[f"depth_values_{l}"]
        return (out[f"depth_{l}"].detach(),
                torch.log(top[:, 0] / top[:, 1]), hyp[:, 1] - hyp[:, 0])
