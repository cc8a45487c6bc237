"""Checkpoint save/load and top-k management.

Counterpart of ``casmvsnet_pl_tpu/utils/checkpoints.py``: a checkpoint is a
plain dict of tensors, numbers and nested dicts written with ``torch.save``
(msgpack there); top-k checkpoints keyed on a monitored metric
(val/acc_2mm, max, k=5) with a restartable index; partial weight loading by
state-dict name prefix for transfer between datasets.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any

import torch

CONVERT_HINT = ("a reference Lightning .ckpt or .pth, or a checkpoint of the "
                "JAX package, is converted first: "
                "python convert_ckpt_torch.py SRC DST")


def file_format(path: str) -> str:
    """What the first bytes of ``path`` say it is: "zip" (``torch.save``'s
    format), "pickle" (a pickle, such as ``torch.save``'s legacy format,
    which PyTorch before 1.6 wrote), "msgpack" (a map: the JAX package's
    checkpoints) or "unknown"."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return "zip"
    if len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "pickle"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    return "unknown"


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically (a temporary file, renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Any:
    """The dict written by :func:`save_checkpoint` (tensors and plain
    Python values only: ``weights_only`` loading). A checkpoint of the JAX
    package, or a reference Lightning file (whose pickle holds more than
    weights, or whose weights sit under ``state_dict``), raises a
    ``ValueError`` that names ``convert_ckpt_torch.py``."""
    if file_format(path) == "msgpack":
        raise ValueError(f"{path} is a msgpack file, not a checkpoint of the "
                         f"port; {CONVERT_HINT}")
    try:
        ckpt = torch.load(path, map_location=map_location, weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path} is not a checkpoint of the port (its pickle "
                         f"holds objects other than tensors and plain "
                         f"values); {CONVERT_HINT}") from e
    if isinstance(ckpt, dict) and "state_dict" in ckpt \
            and "params" not in ckpt:
        raise ValueError(f"{path} holds a Lightning state_dict, not the "
                         f"port's params; {CONVERT_HINT}")
    return ckpt


def extract_model_params(ckpt: dict, prefixes_to_ignore=()) -> dict:
    """The model's state dict from a checkpoint (its ``params``, or the
    dict itself), without the names that start with an ignored prefix."""
    params = ckpt.get("params", ckpt)
    return {k: v for k, v in params.items()
            if not any(k.startswith(p) for p in prefixes_to_ignore)}


def partial_load(state_dict: dict, ckpt_params: dict, prefixes_to_ignore=()
                 ) -> tuple[dict, list[str], list[str]]:
    """``state_dict`` updated with the entries of ``ckpt_params`` that it
    has under the same name and shape; the rest keep their values (so a
    head of another shape keeps its fresh initialization). Returns
    (new_state_dict, loaded_names, skipped_names)."""
    out = dict(state_dict)
    loaded, skipped = [], []
    for k, v in ckpt_params.items():
        if any(k.startswith(p) for p in prefixes_to_ignore):
            skipped.append(k)
        elif k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v
            loaded.append(k)
        else:
            skipped.append(k)
    return out, loaded, skipped


class TopKCheckpointManager:
    """Keep the best-k checkpoints by a monitored scalar metric, with an
    index file of the metric values so that the manager is restartable."""

    def __init__(self, ckpt_dir: str, monitor: str = "val/acc_2mm",
                 mode: str = "max", top_k: int = 5):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self._index_path = os.path.join(ckpt_dir, "index.json")
        os.makedirs(ckpt_dir, exist_ok=True)
        self._index: dict[str, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _worst(self) -> tuple[str, float] | None:
        if not self._index:
            return None
        key = min if self.mode == "max" else max
        name = key(self._index, key=self._index.get)
        return name, self._index[name]

    def save(self, tree: Any, metrics: dict[str, float], epoch: int) -> bool:
        """Save if the metric makes the top-k; returns whether it was kept."""
        value = float(metrics[self.monitor])
        if len(self._index) >= self.top_k:
            worst = self._worst()
            better = (value > worst[1]) if self.mode == "max" \
                else (value < worst[1])
            if not better:
                return False
            os.remove(os.path.join(self.ckpt_dir, worst[0]))
            del self._index[worst[0]]
        name = f"epoch={epoch:02d}.ckpt"
        save_checkpoint(os.path.join(self.ckpt_dir, name), tree)
        self._index[name] = value
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)
        return True

    def best_path(self) -> str | None:
        if not self._index:
            return None
        key = max if self.mode == "max" else min
        name = key(self._index, key=self._index.get)
        return os.path.join(self.ckpt_dir, name)
