"""JAX parameters -> state dict of this package.

The inverse of ``casmvsnet_pl_tpu/utils/torch_convert.py::
convert_state_dict``: it takes the JAX package's ``params`` and
``batch_stats`` (nested dicts of arrays) and returns a state dict that
``CascadeMVSNet.load_state_dict(sd, strict=True)`` accepts.

  - HWIO ``(kh, kw, I, O)``         -> Conv2d ``(O, I, kh, kw)``
  - DHWIO ``(kd, kh, kw, I, O)``    -> Conv3d ``(O, I, kd, kh, kw)``
  - deconv DHWIO (spatially flipped, the JAX decoder runs a forward conv on
    the dilated input)              -> ConvTranspose3d ``(I, O, kd, kh, kw)``
  - BN ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``

Names: ``feature/convA_B/*`` -> ``feature.convA.B.*``;
``cost_reg_L/deconvK/kernel`` -> ``cost_reg_L.convK.0.weight`` and
``cost_reg_L/deconvK/bn/*`` -> ``cost_reg_L.convK.1.*``; the rest keep their
names with ``/`` -> ``.``.

:func:`jax_from_state_dict` maps the other way, so that a checkpoint in
the JAX package's layout can be written without JAX (``chip_smoke.py``).
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(mods) -> list[str]:
    out = []
    for i, m in enumerate(mods):
        stage = re.fullmatch(r"conv(\d)_(\d)", m)
        deconv = re.fullmatch(r"deconv(\d+)", m)
        if stage:
            out += [f"conv{stage[1]}", stage[2]]
        elif deconv:
            out.append(f"conv{deconv[1]}")
        elif m == "bn" and i and mods[i - 1].startswith("deconv"):
            out.append("1")
        else:
            out.append(m)
    return out


def _kernel(mods, w: np.ndarray) -> tuple[list[str], np.ndarray]:
    if mods[-1].startswith("deconv"):
        return ["0"], np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
    if w.ndim == 4:
        return [], np.transpose(w, (3, 2, 0, 1))
    return [], np.transpose(w, (4, 3, 0, 1, 2))


def state_dict_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` -> ``{name: float32 tensor}``."""
    sd: dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, val in _flatten(tree):
            *mods, leaf = path
            names = _module_path(mods)
            w = np.asarray(val, np.float32)
            if leaf == "kernel":
                extra, w = _kernel(mods, w)
                names += extra
            sd[".".join(names + [_LEAF[leaf]])] = torch.from_numpy(w.copy())
            if mods[-1] == "bn" and leaf == "scale":
                sd[".".join(names + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


_JAX_LEAF = {"running_mean": "mean", "running_var": "var", "bias": "bias"}


def jax_from_state_dict(state_dict) -> tuple[dict, dict]:
    """The inverse of :func:`state_dict_from_jax`: a state dict of the
    port (or of the reference) -> the JAX package's ``(params,
    batch_stats)``, nested dicts of float32 numpy arrays in its names and
    layouts (as ``casmvsnet_pl_tpu/utils/torch_convert.py::
    convert_state_dict`` maps them); ``num_batches_tracked`` is dropped."""
    params: dict = {}
    stats: dict = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        w = val.detach().cpu().float().numpy()
        *mods, leaf = key.split(".")
        deconv = (len(mods) >= 3 and re.fullmatch(r"cost_reg_\d", mods[0])
                  and re.fullmatch(r"conv(7|9|11)", mods[1]))
        if deconv:
            # cost_reg_L.convK.0.weight / cost_reg_L.convK.1.<bn leaf>
            path = [mods[0], "de" + mods[1]] + (["bn"] if mods[2] == "1"
                                                 else [])
        elif mods[0] == "feature" and re.fullmatch(r"conv\d", mods[1]):
            path = [mods[0], f"{mods[1]}_{mods[2]}"] + mods[3:]
        else:
            path = mods
        if leaf == "weight" and w.ndim >= 3:
            name = "kernel"
            if deconv:
                w = np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]
            else:
                w = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))
        else:
            name = "scale" if leaf == "weight" else _JAX_LEAF[leaf]
        tree = stats if name in ("mean", "var") else params
        for m in path:
            tree = tree.setdefault(m, {})
        tree[name] = np.ascontiguousarray(w)
    return params, stats
