"""Host-side batching, shuffling and device transfer, numpy and torch only.

Counterpart of ``casmvsnet_pl_tpu/data/loader.py``: a thread pool loads
samples, batches are collated into fixed-shape numpy dicts (each rank's
rows of the global batch when several ranks train), a ragged last batch
can be padded with mask-zeroed repeats, and :func:`prefetch_to_device`
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

from ..parallel import shard_rows


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
    """Minimal epoch-based loader over a sequence-style dataset.

    ``batch_size`` is the global batch. With ``world`` ranks each rank
    loads and yields only its rows ``[rank*b/N, (rank+1)*b/N)`` of every
    global batch (``parallel/dist.py::shard_rows``); every rank shuffles
    the same order from ``seed``, so the ranks' rows together are the
    global batches that one process yields (and that the JAX package's
    loader yields with the same seed). A ragged last global batch is
    dropped or, with ``pad_last``, padded before it is sliced.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool | None = None,
                 pad_last: bool = False, seed: int = 0, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        # shuffled epochs drop the ragged last batch unless told otherwise
        self.drop_last = drop_last if drop_last is not None else shuffle
        # pad_last: cover every sample with fixed shapes; the padded rows
        # repeat the last real sample with zeroed masks
        self.pad_last = pad_last and not self.drop_last
        if world > 1 and not (self.drop_last or self.pad_last):
            raise ValueError("a ragged last batch cannot be split between "
                             "ranks: drop it or pad it")
        self.rows = shard_rows(batch_size, rank, world)
        self._rng = np.random.RandomState(seed)

    def skip_epochs(self, n: int) -> None:
        """Advance the shuffle as ``n`` epochs would (a resumed run then
        sees the batches an uninterrupted one would)."""
        if self.shuffle:
            order = np.arange(len(self.dataset))
            for _ in range(n):
                self._rng.shuffle(order)

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
                n_real = len(idxs)
                rows = range(self.rows.start, self.rows.stop)
                if not self.pad_last:
                    rows = rows[:max(0, n_real - self.rows.start)]
                # a padded row repeats the global batch's last real sample
                local = [idxs[min(j, n_real - 1)] for j in rows]
                padded = [i for i, j in enumerate(rows) if j >= n_real]
                pending.append((pool.map(self.dataset.__getitem__, local),
                                padded))

            ahead = min(2, nb)
            for bi in range(ahead):
                submit(bi)
            for bi in range(nb):
                if bi + ahead < nb:
                    submit(bi + ahead)
                samples, padded = pending.popleft()
                batch = collate(list(samples))
                for v in batch.get("masks", {}).values():
                    v[padded] = 0
                yield batch


def to_device(batch: dict, device,
              float_dtype: torch.dtype = torch.float32) -> dict:
    """numpy batch -> tensors on ``device`` (``scan_vid`` stays a list),
    float32 arrays as ``float_dtype``. On a CUDA device the host arrays are
    pinned and copied with ``non_blocking=True``, so the copy overlaps work
    already queued."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if cuda:
            t = t.pin_memory()
        t = t.to(device, non_blocking=cuda)
        return t.to(float_dtype) if t.dtype == torch.float32 else t

    out = {}
    for key, val in batch.items():
        if key == "scan_vid":
            out[key] = val
        elif isinstance(val, dict):
            out[key] = {k: put(v) for k, v in val.items()}
        else:
            out[key] = put(val)
    return out


def prefetch_to_device(iterator: Iterator[dict], device, size: int = 2,
                       float_dtype: torch.dtype = torch.float32
                       ) -> Iterator[dict]:
    """Yield the batches of ``iterator`` on ``device`` (:func:`to_device`),
    with up to ``size`` transfers issued ahead of the batch being used."""
    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch, device, float_dtype))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
