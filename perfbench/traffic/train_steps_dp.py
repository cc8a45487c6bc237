"""Data-parallel training steps: ``train_steps`` on ``chips`` ranks.

This process is rank 0; it starts ranks 1 .. N-1 (``spawn``), one card a
rank, each with one intra-op thread (``torchrun``'s
``OMP_NUM_THREADS=1``), and every rank joins the port's process group
(``parallel/dist.py::initialize_distributed``: NCCL on the card, gloo on the
CPU) through a file rendezvous in a fresh temporary directory, so the
trainer wraps the model in ``DistributedDataParallel`` with SyncBN, as
``train_torch.py`` runs under ``torchrun``. Each rank stages its own rows
of every global batch; rank 0 decides the window's end over a gloo group
of its own, gathers the fullest card's peak memory, follows the reference
over the global batches, and returns the result. Every rank is joined
before this returns; a rank that has not ended in time is killed.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from perfbench import faults, program
from perfbench.harness import Ctx
from perfbench.traffic.train_steps import train_run

JOIN_S = 120.0
THREADS = 1                    # torchrun's OMP_NUM_THREADS for each worker
GROUP_TIMEOUT_S = 300.0        # a rank that waits longer on a collective fails


def _rank(rank: int, world: int, init: str, ctx: Ctx) -> list[dict | None]:
    from casmvsnet_pl_tpu_torch.parallel import initialize_distributed
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.set_num_threads(THREADS)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    ctx.device = device
    initialize_distributed(rank, world, init, device=device,
                           timeout_s=GROUP_TIMEOUT_S)
    try:
        group = dist.new_group(backend="gloo")
        faults.plant(ctx.fault, ctx.config)
        return [train_run(ctx, seed, rank, world, group)
                for seed in ctx.seeds]
    finally:
        dist.destroy_process_group()


def run(ctx: Ctx) -> list[dict]:
    world = ctx.cell["chips"]
    if torch.device(ctx.device).type == "cuda":
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks, {torch.cuda.device_count()} "
                               "cards")
        program.build_kernels()       # ranks load the library, none builds
    tmp = tempfile.mkdtemp(prefix="perfbench_rdv_")
    init = "file://" + os.path.join(tmp, "store")
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_rank, args=(r, world, init, ctx))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        results = _rank(0, world, init, ctx)
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return results
