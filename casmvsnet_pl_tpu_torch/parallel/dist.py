"""Data parallelism over ``torch.distributed``: process groups, ranks,
devices and batch slices, and the launcher that starts the ranks.

Counterpart of ``casmvsnet_pl_tpu/parallel/mesh.py``. There the global
batch is sharded on a mesh's ``data`` axis and XLA reduces the gradients;
here each rank is a process that holds a replica of the model, takes its
contiguous rows ``[r*b/N, (r+1)*b/N)`` of every global batch of ``b`` rows,
and ``DistributedDataParallel`` averages the gradients (the trainer wraps
the model; BatchNorm statistics and the loss's mask counts are global,
``parallel/sync_bn.py`` and ``losses.py``). NCCL on CUDA, one card a
rank; gloo on the CPU or when asked for, where ranks may share a card.
Without a process group every helper here is the single-process identity:
rank 0 of 1.

:func:`spawn` starts N ranks with the ``spawn`` method and a file
rendezvous in a fresh temporary directory (no fixed TCP port, so
concurrent runs cannot collide); a rank that raises ends the others, and
every wait has a timeout. CUDA ranks find the kernel library built.
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
    NCCL on a CUDA ``device`` and gloo otherwise. NCCL raises
    ``ValueError`` when this rank's index on its host (``LOCAL_RANK``, as
    torchrun sets it, else ``rank``) has no card of its own: a world may
    span hosts, so only the local index is held to this host's cards.
    Every collective fails after ``timeout_s`` instead of hanging."""
    if backend is None:
        backend = "nccl" if device is not None and \
            torch.device(device).type == "cuda" else "gloo"
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl" and local >= torch.cuda.device_count():
        raise ValueError(f"NCCL rank {rank} has index {local} on this host "
                         f"(LOCAL_RANK, else the rank), "
                         f"{torch.cuda.device_count()} cards visible: NCCL "
                         f"takes one card a rank (gloo ranks may share a "
                         f"card: backend='gloo')")
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
    visible (so several gloo ranks may share one card; :func:`spawn` and
    :func:`initialize_distributed` refuse NCCL ranks first), made the
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


def check_same_on_ranks(value: int, what: str, device) -> None:
    """Raise on every rank unless ``value`` is the same on all of them (one
    all-reduce of ``value`` and ``-value`` with MAX, on ``device``): a
    rank that ran fewer collectives than the others would hang them."""
    if not is_distributed():
        return
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    high, low = int(t[0]), -int(t[1])
    if high != low:
        raise RuntimeError(f"{what} differ across the ranks: {low} to "
                           f"{high}")


def barrier() -> None:
    """Wait for every rank (on NCCL, on this rank's current card)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
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
    ended by then (all are ended).

    CUDA ranks (``cpu`` false) take NCCL unless ``backend`` says
    otherwise, and NCCL raises ``ValueError`` here, before any rank
    starts, when ``world`` outnumbers the cards: NCCL takes one card a
    rank (two ranks on one card fail with "Duplicate GPU detected").
    The kernel library is built here before the ranks start, so that each
    loads it rather than running ``nvcc`` itself."""
    import torch.multiprocessing as mp

    if not cpu:
        cards = torch.cuda.device_count()
        if (backend or "nccl") == "nccl" and world > cards:
            raise ValueError(f"{world} NCCL ranks on this host, {cards} "
                             f"cards visible: NCCL takes one card a rank "
                             f"(gloo ranks may share a card: "
                             f"backend='gloo')")
        from ..kernels import cost_volume_cuda
        cost_volume_cuda.build()

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
