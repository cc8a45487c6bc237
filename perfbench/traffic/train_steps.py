"""Training steps: ``MVSTrainer.train_step`` back to back on staged batches.

Set-up builds one trainer and its state (``program.trainer``: the seed's
weights, float32 parameters, bf16 autocast on the card, the configuration's
Adam) and stages ``pool`` batches of ``batch`` distinct scenes on the device
(in a process group, this rank's rows of each global batch). Its first
``compared_steps`` steps, on batches 0, 1, 2, are the steps the reference
follows; they also warm every shape up. The window then steps the same
state on the next batches in turn, so no two neighbouring steps see the same
batch, until ``seconds`` have passed (in a process group rank 0 decides,
every ``check_every`` steps, over a gloo group of its own).

End-to-end: ``samples_per_s`` (samples of every rank over the window),
``peak_mem_gib`` (``max_memory_allocated`` over the window, the fullest
card), ``setup_s``.

``correct``: the first steps' losses, the first gradient as Adam took it
(its first moment after one step over 1 - beta1) and the parameters' change
over those steps, against the plain reference's float32 steps over the same
(global) batches from the same weights (``compare.py``); and K1's and K2's
launches, one a level a step each.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.distributed import all_reduce as _all_reduce

from perfbench import compare, faults, program, scenes, trace
from perfbench.harness import Ctx, GIB, Phases, result
from perfbench.reference.model import float32_exact
from perfbench.reference.train import BETAS, train_steps


def run(ctx: Ctx) -> list[dict]:
    faults.plant(ctx.fault, ctx.config)
    return [train_run(ctx, seed) for seed in ctx.seeds]


def _rows(j: int, B: int, rank: int, world: int) -> range:
    """The scenes of rank ``rank``'s rows of global batch ``j``."""
    first = j * B * world + rank * B
    return range(first, first + B)


def global_batch(ctx: Ctx, seed: int, j: int, world: int) -> dict:
    B = ctx.mix["batch"]
    return scenes.make_batch(seed, range(j * B * world, (j + 1) * B * world),
                             ctx.img_wh, ctx.mix["n_views"], ctx.mix["focal"],
                             ctx.config, ctx.device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_run(ctx: Ctx, seed: int, rank: int = 0, world: int = 1,
              group=None) -> dict | None:
    """One seed's run on this rank; the result on rank 0, None elsewhere.
    ``group`` is the gloo group of a process group's ranks."""
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    B, P, first = mix["batch"], mix["pool"], mix["compared_steps"]
    phases = Phases()
    weights = program.draw_weights(cfg, seed, device)
    tr, state = program.trainer(cfg, weights, device)
    phases.mark("weights and trainer")
    pool = [scenes.make_batch(seed, _rows(j, B, rank, world), ctx.img_wh,
                              mix["n_views"], mix["focal"], cfg, device)
            for j in range(P)]
    phases.mark("scenes")
    named = list(state.model.named_parameters())
    before = program.launch_counts()
    losses, grads = [], None
    for j in range(first):
        state, logs = tr.train_step(state, pool[j])
        losses.append(float(logs["train/loss"]))
        if j == 0:
            grads = {n: state.optimizer.state[p]["exp_avg"] / (1 - BETAS[0])
                     for n, p in named}
    change = {n: p.detach() - weights[n] for n, p in named}
    after = program.launch_counts()
    _sync(device)
    phases.mark("compared steps")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if group is not None:
        dist.barrier(group=group)
    setup_s = time.perf_counter() - ctx.t_start
    if rank == 0:
        phases.report(setup_s)
    flag = torch.zeros(1, dtype=torch.int32)

    def window(limit_s: float | None, units: int | None) -> int:
        n, t0 = 0, time.perf_counter()
        while True:
            if units is not None:
                if n >= units:
                    break
            elif n % mix["check_every"] == 0:
                flag.fill_(int(time.perf_counter() - t0 >= limit_s))
                if group is not None:
                    _all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
                if flag.item():
                    break
            tr.train_step(state, pool[(first + n) % P])
            n += 1
        _sync(device)
        if group is not None:
            dist.barrier(group=group)
        return n

    summary = None
    t0 = time.perf_counter()
    if ctx.trace:
        n, events = trace.profile(lambda: window(None, mix["trace_units"]))
        summary = trace.summarize(events)
    else:
        n = window(ctx.seconds, None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if group is not None:
        stats = torch.tensor([float(peak)], dtype=torch.float64)
        _all_reduce(stats, op=dist.ReduceOp.MAX, group=group)
        peak = int(stats.item())
        if summary is not None:
            busy = torch.tensor([summary["busy_s"], summary["window_s"]],
                                dtype=torch.float64)
            _all_reduce(busy, group=group)
            summary["busy_s_mean"], summary["window_s_mean"] = \
                (busy / world).tolist()
    del tr, state, pool
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    batches = [global_batch(ctx, seed, j, world) for j in range(first)]
    with float32_exact():
        ref = train_steps(cfg, weights, batches)
    numbers = compare.train_numbers(losses, grads, change, ref)
    if cuda:                    # K1 and K2 once a level a step, no fallback
        for k, name in (("k1", "cost_volume_cuda"),
                        ("k2", "cost_volume_bwd_cuda")):
            per = (after[name] - before[name]) / first
            numbers[f"{k}_launch_gap"] = abs(per - cfg["levels"])
    table = compare.checks(numbers, ctx.cell["limits"], cuda)
    ok = compare.passed(table)
    return result(
        metrics={"samples_per_s": n * B * world / wall,
                 "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        attempted=n, failed=0 if ok else first, checks=table,
        peak_bytes=peak, chips=world, trace=summary, units=n,
        numbers=numbers)


def control_numbers(ctx: Ctx, seed: int, world: int) -> dict:
    """The control alone, with no program: the reference in fp8 against the
    reference in float32 over the cell's first global batches of ``world``
    ranks, from the seed's weights (a data-parallel cell's control needs
    one card)."""
    cfg, first = ctx.config, ctx.mix["compared_steps"]
    weights = program.draw_weights(cfg, seed, ctx.device)
    batches = [global_batch(ctx, seed, j, world) for j in range(first)]
    with float32_exact():
        ref = train_steps(cfg, weights, batches)
        ctl = train_steps(cfg, weights, batches, quant="fp8")
    return compare.train_numbers(ctl["losses"], ctl["grads"], ctl["change"],
                                 ref)
