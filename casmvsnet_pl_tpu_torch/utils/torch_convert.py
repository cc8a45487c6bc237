"""Checkpoints written outside the port -> the port's checkpoint dict.

Counterpart of ``casmvsnet_pl_tpu/utils/torch_convert.py``. Two kinds of
file become ``{"params": {name: tensor}, "batch_stats": {name: tensor}}``,
the dict that ``eval_torch.py --ckpt_path``, ``train_torch.py
--ckpt_path`` and ``demo_torch.py --ckpt_path`` read (through
``utils/checkpoints.py``) and load with ``strict=True``:

  - **A reference (kwea123/CasMVSNet_pl) PyTorch-Lightning ``.ckpt``, or
    a plain ``.pth`` state dict.** The model's weights are its
    ``state_dict`` (or the file's dict itself), ``model.``-prefixed. Their
    names are the port's own (``feature.conv0.0.conv.weight``,
    ``cost_reg_L.conv7.0.weight``, ``cost_reg_L.prob.*``) and so are their
    layouts, so no tensor is transposed. Keys that are not the model's
    (``loss.*``, ...) are skipped and reported as the JAX converter
    reports them; InPlace-ABN keeps no ``num_batches_tracked``, so those
    buffers are added (0). Every tensor is cast to float32.
  - **A checkpoint of the JAX package** (flax msgpack, written by
    ``casmvsnet_pl_tpu/utils/checkpoints.py::save_checkpoint``), read with
    the port's own decoder (``utils/msgpack.py``). Its ``params`` (or the
    tree itself) and ``batch_stats`` go through
    ``utils/convert.py::state_dict_from_jax``. Its ``opt_state`` and
    ``step`` are read and ignored: the reference's ``load_ckpt`` restores
    weights only, as a warm start does.

A file that is neither, or that lacks a tensor of the model, raises a
``ValueError`` that names the file and what it lacks; nothing is returned
half-filled.

**Unpickling.** A Lightning file is untrusted input, and it is not weights
only: PL 0.7.5 pickles ``hparams`` (an ``argparse.Namespace``),
``optimizer_states`` and ``lr_schedulers`` (the reference's warm-up
scheduler pickles scheduler objects), and PyTorch 1.4, which the
reference pins, wrote the legacy (non-zip) format. ``torch.load``'s
``weights_only=True`` refuses such files, and ``weights_only=False``
alone would import and call whatever globals the pickle names. So the
file is read with ``weights_only=False`` and a ``pickle_module`` whose
unpickler allows by name only the globals that rebuild tensors (torch's
own loader resolves the storage types) and ``OrderedDict``; every other
global becomes an inert stand-in, a class whose construction only records
its arguments, so that nothing of the file's choosing runs. The weights
need nothing else, and the stand-ins are dropped with the rest of the
file.
"""
from __future__ import annotations

import collections
import pickle
from collections.abc import Mapping

import torch

from .checkpoints import file_format
from .convert import state_dict_from_jax
from .msgpack import MsgpackError, restore

# the globals a state dict's tensors are rebuilt from (module, name)
ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): torch._utils._rebuild_parameter,
}


class StandIn:
    """What a pickled global outside :data:`ALLOWED_GLOBALS` becomes:
    calling, building or filling it records its arguments and runs
    nothing. ``name`` is the global it stands for."""

    name = ""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        self.items: list = []

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        self.items.append((key, value))

    def append(self, value):
        self.items.append(value)

    def extend(self, values):
        self.items.extend(values)

    def __repr__(self):
        return f"<stand-in for {self.name}>"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        found = ALLOWED_GLOBALS.get((module, name))
        if found is not None:
            return found
        return type("StandIn", (StandIn,), {"name": f"{module}.{name}"})


class RestrictedPickle:
    """The ``pickle_module`` given to ``torch.load``: its ``Unpickler``
    and ``load`` resolve only :data:`ALLOWED_GLOBALS`."""

    Unpickler = _Unpickler

    @staticmethod
    def load(file, **kwargs):
        return _Unpickler(file, **kwargs).load()


def _model_names() -> tuple[set[str], set[str]]:
    """(parameter names, buffer names) of ``CascadeMVSNet``; they do not
    depend on its config (``num_groups`` changes shapes only)."""
    from ..models import CascadeMVSNet
    with torch.device("meta"):
        model = CascadeMVSNet()
    return ({k for k, _ in model.named_parameters()},
            {k for k, _ in model.named_buffers()})


def split_state_dict(state_dict: Mapping, what: str
                     ) -> tuple[dict, dict, list[str]]:
    """A state dict in the model's names -> ``(params, batch_stats,
    skipped)``: a ``model.`` prefix stripped, every tensor float32
    (``num_batches_tracked`` int64, 0 where absent), names that are not
    the model's skipped (as ``convert_state_dict`` of the JAX package
    skips them, ``num_batches_tracked`` dropped silently there). Raises a
    ``ValueError`` naming ``what`` and the missing keys if the model's
    weights are not all there."""
    param_names, buffer_names = _model_names()
    params, stats, skipped = {}, {}, []
    for key, val in state_dict.items():
        if not isinstance(key, str):
            raise ValueError(f"{what}: a key of type {type(key).__name__}")
        if key.startswith("model."):
            key = key[len("model."):]
        if key not in param_names and key not in buffer_names:
            if not key.endswith("num_batches_tracked"):
                skipped.append(key)
            continue
        if not isinstance(val, torch.Tensor):
            raise ValueError(f"{what}: {key} is a {type(val).__name__}, not "
                             "a tensor")
        if key.endswith("num_batches_tracked"):
            val = val.detach().to(torch.int64).clone()
        elif val.is_floating_point():
            val = val.detach().to(torch.float32).clone()
        else:
            raise ValueError(f"{what}: {key} has dtype {val.dtype}")
        (params if key in param_names else stats)[key] = val
    for name in sorted(buffer_names - set(stats)):
        if name.endswith("num_batches_tracked"):
            stats[name] = torch.tensor(0)
    # the weights first, then the BatchNorm statistics
    missing = (sorted(param_names - set(params))
               + sorted(buffer_names - set(stats)))
    if missing:
        more = f" and {len(missing) - 8} more" if len(missing) > 8 else ""
        raise ValueError(f"{what}: missing {', '.join(missing[:8])}{more}")
    return params, stats, skipped


def read_torch_checkpoint(path: str) -> Mapping:
    """The state dict of a reference ``.ckpt`` (its ``state_dict``) or of a
    plain ``.pth`` (the file's dict), unpickled with :class:`
    RestrictedPickle`."""
    blob = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=RestrictedPickle)
    if not isinstance(blob, Mapping):
        raise ValueError(f"{path}: holds a {type(blob).__name__}, not a "
                         "checkpoint dict")
    state_dict = blob.get("state_dict", blob)
    if not isinstance(state_dict, Mapping):
        raise ValueError(f"{path}: its state_dict is a "
                         f"{type(state_dict).__name__}, not a dict")
    return state_dict


def read_jax_checkpoint(path: str) -> dict:
    """A JAX-package checkpoint's state dict, in the port's names
    (``state_dict_from_jax`` of its ``params`` and ``batch_stats``)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        tree = restore(data)
    except MsgpackError as e:
        raise ValueError(f"{path}: {e}") from None
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: holds a {type(tree).__name__}, not a "
                         "checkpoint dict")
    # opt_state and step are read and ignored: weights only, as the
    # reference's load_ckpt restores them
    params = tree.get("params", {k: v for k, v in tree.items() if k not in (
        "batch_stats", "opt_state", "step")})
    batch_stats = tree.get("batch_stats", {})
    if not isinstance(params, dict) or not isinstance(batch_stats, dict):
        raise ValueError(f"{path}: params and batch_stats must be maps")
    try:
        return state_dict_from_jax(params, batch_stats)
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise ValueError(f"{path}: not the JAX model's parameters "
                         f"({type(e).__name__}: {e})") from None


def report_skipped(skipped: list[str]) -> None:
    """Print the skipped keys as the JAX package's converter does."""
    if skipped:
        print(f"convert: skipped {len(skipped)} non-model keys: "
              f"{sorted(skipped)[:8]}{'...' if len(skipped) > 8 else ''}")


def convert_checkpoint(path: str) -> dict:
    """A reference ``.ckpt``/``.pth`` or a JAX-package checkpoint ->
    ``{"params", "batch_stats"}`` of the port, the format told from the
    file's first bytes; skipped keys are reported on stdout."""
    fmt = file_format(path)
    if fmt in ("zip", "pickle"):
        state_dict = read_torch_checkpoint(path)
    elif fmt == "msgpack":
        state_dict = read_jax_checkpoint(path)
    else:
        raise ValueError(f"{path}: neither a PyTorch file (zip or pickle) "
                         "nor a msgpack checkpoint of the JAX package")
    params, stats, skipped = split_state_dict(state_dict, path)
    report_skipped(skipped)
    return {"params": params, "batch_stats": stats}
