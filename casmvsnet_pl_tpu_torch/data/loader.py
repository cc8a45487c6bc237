"""Host-side batching, shuffling and device transfer, numpy and torch only.

Counterpart of ``casmvsnet_pl_tpu/data/loader.py``: a thread pool loads
samples, batches are collated into fixed-shape numpy dicts, a ragged last
batch can be padded with mask-zeroed repeats, and :func:`prefetch_to_device`
moves batches to the device ahead of use (pinned host memory and
``non_blocking`` copies on a CUDA device, the counterpart of the JAX
package's ``prefetch_to_device``).
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into a batch dict (numpy)."""
    batch: dict[str, Any] = {}
    first = samples[0]
    for key in first:
        if key == "scan_vid":
            batch[key] = [s[key] for s in samples]
        elif isinstance(first[key], dict):
            batch[key] = {k: np.stack([s[key][k] for s in samples])
                          for k in first[key]}
        else:
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    return batch


class DataLoader:
    """Minimal epoch-based loader over a sequence-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool | None = None,
                 pad_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        # shuffled epochs drop the ragged last batch unless told otherwise
        self.drop_last = drop_last if drop_last is not None else shuffle
        # pad_last: cover every sample with fixed shapes; the padded rows
        # repeat real samples with zeroed masks (see pad_batch)
        self.pad_last = pad_last and not self.drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        nb = len(self)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()     # two batches ahead

            def submit(bi):
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                pending.append(pool.map(self.dataset.__getitem__, idxs))

            ahead = min(2, nb)
            for bi in range(ahead):
                submit(bi)
            for bi in range(nb):
                if bi + ahead < nb:
                    submit(bi + ahead)
                batch = collate(list(pending.popleft()))
                n_real = min(self.batch_size,
                             len(self.dataset) - bi * self.batch_size)
                if self.pad_last and n_real < self.batch_size:
                    batch = pad_batch(batch, self.batch_size, n_real)
                yield batch


def pad_batch(batch: dict, batch_size: int, n_real: int) -> dict:
    """Pad a ragged batch to ``batch_size`` rows with mask-zeroed repeats:
    every array repeats its last real row, and the ``masks`` pyramid is
    zeroed on the padded rows, so they add nothing to the mask-gated loss
    and pixel-weighted metric sums."""
    pad = batch_size - n_real

    def pad_arr(x):
        if isinstance(x, list):
            return x + [x[-1]] * pad
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

    out = {}
    for key, val in batch.items():
        if isinstance(val, dict):
            out[key] = {k: pad_arr(v) for k, v in val.items()}
        else:
            out[key] = pad_arr(val)
    if "masks" in out:
        for k, v in out["masks"].items():
            v = v.copy()
            v[n_real:] = 0
            out["masks"][k] = v
    return out


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (``scan_vid`` stays a list).
    On a CUDA device the host arrays are pinned and copied with
    ``non_blocking=True``, so the copy overlaps work already queued."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    out = {}
    for key, val in batch.items():
        if key == "scan_vid":
            out[key] = val
        elif isinstance(val, dict):
            out[key] = {k: put(v) for k, v in val.items()}
        else:
            out[key] = put(val)
    return out


def prefetch_to_device(iterator: Iterator[dict], device,
                       size: int = 2) -> Iterator[dict]:
    """Yield the batches of ``iterator`` on ``device``, with up to ``size``
    transfers issued ahead of the batch being used."""
    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
