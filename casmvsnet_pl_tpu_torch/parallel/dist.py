"""Data parallelism over ``torch.distributed``: process groups, ranks,
devices and batch slices, and the launcher that starts the ranks.

Counterpart of ``casmvsnet_pl_tpu/parallel/mesh.py``. There the global
batch is sharded on a mesh's ``data`` axis and XLA reduces the gradients;
here each rank is a process that holds a replica of the model, takes its
contiguous rows ``[r*b/N, (r+1)*b/N)`` of every global batch of ``b`` rows,
and ``DistributedDataParallel`` averages the gradients (the trainer wraps
the model; BatchNorm statistics and the loss's mask counts are global,
``parallel/sync_bn.py`` and ``losses.py``). NCCL on CUDA, gloo on the CPU
or when asked for. Without a process group every helper here is the
single-process identity: rank 0 of 1.

:func:`spawn` starts N ranks with the ``spawn`` method and a file
rendezvous in a fresh temporary directory (no fixed TCP port, so
concurrent runs cannot collide); a rank that raises ends the others, and
every wait has a timeout.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


def initialize_distributed(rank: int, world_size: int, init_method: str,
                           backend: str | None = None,
                           device: torch.device | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group as ``rank`` of ``world_size`` through
    ``init_method`` (``file://...`` or ``env://``). ``backend`` defaults to
    NCCL on a CUDA ``device`` and gloo otherwise; every collective then
    fails after ``timeout_s`` instead of hanging."""
    if backend is None:
        backend = "nccl" if device is not None and \
            torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def is_distributed() -> bool:
    """Whether this process is one rank of several."""
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_device(rank: int, cpu: bool = False) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` modulo the cards
    visible (so several ranks may share one card, over gloo), made the
    current device."""
    if cpu:
        return torch.device("cpu")
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def shard_rows(batch_size: int, rank: int, world: int) -> slice:
    """The rows of ``rank`` in a global batch of ``batch_size`` rows."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} is not divisible by the "
                         f"{world} ranks")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global batch dict (numpy arrays or tensors
    with the batch first, and lists; nested dicts alike)."""
    def first(x):
        return first(next(iter(x.values()))) if isinstance(x, dict) else x

    rows = shard_rows(len(first(batch)), rank, world)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return x[rows]

    return take(batch)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` itself without
    a process group)."""
    if not is_distributed():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def all_reduce_dict(values: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Each 0-d tensor of ``values`` (one dtype) summed over the ranks, in
    one all-reduce."""
    if not is_distributed() or not values:
        return values
    names = list(values)
    summed = all_reduce_sum(torch.stack([values[k] for k in names]))
    return dict(zip(names, summed.unbind()))


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str,
                backend: str | None, cpu: bool, threads: int,
                timeout_s: float, args: tuple) -> None:
    device = rank_device(rank, cpu)
    if cpu:
        torch.set_num_threads(threads)
    initialize_distributed(rank, world, init_method, backend, device,
                           timeout_s)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, cpu: bool = False,
          backend: str | None = None, timeout_s: float | None = None,
          pg_timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes,
    each in the process group (file rendezvous) on its device
    (:func:`rank_device`); CPU ranks share this process's intra-op
    threads. ``fn`` and ``args`` must pickle (a function of an importable
    module). Returns when every rank has returned; raises if one raised
    (the others are ended) or, with ``timeout_s``, if they have not all
    ended by then (all are ended)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="casmvs_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    try:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, init_method, backend, cpu,
                               max(1, torch.get_num_threads() // world),
                               pg_timeout_s, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(timeout=30)
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{timeout_s} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
