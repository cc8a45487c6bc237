"""Training steps of a model whose objective is TransMVSNet's focal loss:
``MVSTrainer.train_step`` back to back on staged batches, as
``train_steps.py`` runs them, followed by ``reference/train_focal.py``.

The loop is ``train_steps.py``'s (its helpers imported; ``train_run``
copied with the reference step swapped): set-up builds the trainer and
stages ``pool`` batches of ``batch`` distinct scenes; the first
``compared_steps`` steps, on batches 0, 1, 2, warm every shape up and are
the steps the reference follows; the window then steps the same state on
the next batches in turn until ``seconds`` have passed. One card: the
cell's reference batches are this card's.

End-to-end: ``samples_per_s``, ``peak_mem_gib``, ``setup_s``, as
``train_steps.py``'s.

``correct``: ``compare.train_numbers`` (the first steps' losses, the first
gradient as Adam took it, the parameters' change over the steps) against
the reference's float32 steps over the same batches from the same weights,
:func:`focal_numbers` (the first step's cost volumes against the
reference's, over the gap bf16 opens in the reference itself; the
program's winner-take-all depths against the reference's own where its
largest probability leads clearly), and the architecture's launch checks.
The reference's windows of levels 1 and 0 are centred on the program's
winner-take-all depths of the same step (recorded during the compared
steps by a hook on the model's ``depth_and_confidence``), so that a
winner-take-all flip between bf16 and float32 on a near tie does not move
a window; the loss, every gradient, the change and the volumes remain the
reference's own, and ``wta_gap`` holds the recorded depths to the
reference's own winners.

The control (``Ctx.mode`` "control", as ``readings.py --mode control``
runs it): the reference in fp8 against the reference in float32, with no
program, both centred on the float32 reference's own depths; its own
winner-take-all depths in the program's place.
"""
from __future__ import annotations

import math
import time

import torch

from perfbench import compare, faults, program, scenes, trace
from perfbench.harness import Ctx, GIB, Phases, architecture, result
from perfbench.reference.model import float32_exact
from perfbench.reference.train import BETAS
from perfbench.reference.train_focal import first_volumes, train_steps
from perfbench.traffic.train_steps import _rows, _sync, global_batch

def run(ctx: Ctx) -> list[dict]:
    if ctx.mode == "control":
        return [result(numbers=control_numbers(ctx, seed, 1))
                for seed in ctx.seeds]
    faults.plant(ctx.fault, ctx.config)
    return [train_run(ctx, seed) for seed in ctx.seeds]


def record_centres(model) -> tuple[list, callable]:
    """Hook the model's ``depth_and_confidence``: every level's depth, as
    the forward turns each probability volume into it, is appended
    (detached, float32) to the returned list, coarse to fine; the returned
    function removes the hook."""
    seen = []
    inner = model.depth_and_confidence

    def hook(prob, depth_values):
        depth, conf = inner(prob, depth_values)
        seen.append(depth.detach().float().clone())
        return depth, conf
    model.depth_and_confidence = hook

    def remove():
        del model.depth_and_confidence
    return seen, remove


def step_centres(seen: list, levels: int) -> list[dict]:
    """The recorded depths by step: {l: (B, h_l, w_l)} for l = 1 .. L-1,
    the levels whose depth centres a finer window."""
    return [{levels - 1 - i: seen[j + i] for i in range(levels - 1)}
            for j in range(0, len(seen), levels)]


def train_run(ctx: Ctx, seed: int) -> dict:
    """One seed's run on one card."""
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    B, P, first = mix["batch"], mix["pool"], mix["compared_steps"]
    phases = Phases()
    weights = program.draw_weights(cfg, seed, device)
    tr, state = program.trainer(cfg, weights, device)
    phases.mark("weights and trainer")
    pool = [scenes.make_batch(seed, _rows(j, B, 0, 1), ctx.img_wh,
                              mix["n_views"], mix["focal"], cfg, device)
            for j in range(P)]
    phases.mark("scenes")
    named = list(state.model.named_parameters())
    before = program.launch_counts()
    seen, unhook = record_centres(state.model)
    volumes, unhook_volumes = record_volumes(state.model, cfg["levels"])
    losses, grads = [], None
    try:
        for j in range(first):
            state, logs = tr.train_step(state, pool[j])
            losses.append(float(logs["train/loss"]))
            if j == 0:
                grads = {n: state.optimizer.state[p]["exp_avg"]
                         / (1 - BETAS[0]) for n, p in named}
    finally:
        unhook()
        unhook_volumes()
    change = {n: p.detach() - weights[n] for n, p in named}
    after = program.launch_counts()
    _sync(device)
    phases.mark("compared steps")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - ctx.t_start
    phases.report(setup_s)

    def window(limit_s: float | None, units: int | None) -> int:
        n, t0 = 0, time.perf_counter()
        while True:
            if units is not None:
                if n >= units:
                    break
            elif n % mix["check_every"] == 0 and \
                    time.perf_counter() - t0 >= limit_s:
                break
            tr.train_step(state, pool[(first + n) % P])
            n += 1
        _sync(device)
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
    del tr, state, pool
    if cuda:
        torch.cuda.empty_cache()

    batches = [global_batch(ctx, seed, j, 1) for j in range(first)]
    centres = step_centres(seen, cfg["levels"])
    with float32_exact():
        ref = train_steps(cfg, weights, batches, centres=centres)
        bf16 = bf16_volumes(cfg, weights, batches[0], centres[0])
    numbers = compare.train_numbers(losses, grads, change, ref)
    numbers.update(focal_numbers(ref, centres[0], volumes, bf16))
    if cuda:
        numbers.update(compare.launch_gaps(
            architecture(cfg).launch_checks(cfg, train=True), before, after,
            first))
    table = compare.checks(numbers, ctx.cell["limits"], cuda)
    ok = compare.passed(table)
    return result(
        metrics={"samples_per_s": n * B / wall,
                 "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        attempted=n, failed=0 if ok else first, checks=table,
        peak_bytes=peak, chips=1, trace=summary, units=n, numbers=numbers)


def control_numbers(ctx: Ctx, seed: int, world: int = 1) -> dict:
    """The control alone, with no program: the reference in fp8 against the
    reference in float32 over the cell's first batches, from the seed's
    weights, both centred on the float32 reference's depths."""
    cfg, first = ctx.config, ctx.mix["compared_steps"]
    weights = program.draw_weights(cfg, seed, ctx.device)
    batches = [global_batch(ctx, seed, j, world) for j in range(first)]
    with float32_exact():
        ref = train_steps(cfg, weights, batches)
        ctl = train_steps(cfg, weights, batches, quant="fp8",
                          centres=ref["centres"])
        bf16 = bf16_volumes(cfg, weights, batches[0], ref["centres"][0])
    numbers = compare.train_numbers(ctl["losses"], ctl["grads"],
                                    ctl["change"], ref)
    numbers.update(focal_numbers(
        ref, {l: w[0] for l, w in ctl["wta"].items()}, ctl["volumes"],
        bf16))
    return numbers


LEAD = 1.0     # log(largest / second largest probability): a clear lead


def record_volumes(model, levels: int) -> tuple[dict, callable]:
    """Hook each level's ``cost_reg_l``: the first volume it takes, as
    (B, D, h, w) float32 on the host (so that the window's peak memory is
    the program's), into the returned {l: ...}; the returned function
    removes the hooks."""
    seen = {}

    def hook(l):
        def pre(module, args):
            if l not in seen:
                seen[l] = args[0].detach()[..., 0].to("cpu", torch.float32,
                                                       copy=True)
        return pre
    handles = [getattr(model, f"cost_reg_{l}").register_forward_pre_hook(
        hook(l)) for l in range(levels)]

    def remove():
        for h in handles:
            h.remove()
    return seen, remove


def bf16_volumes(cfg: dict, weights: dict, batch: dict,
                 centres: dict) -> dict:
    """The reference's first-step volumes under bf16 autocast, centred as
    the compared step is: the yardstick of ``volume_vs_bf16``."""
    device = next(iter(weights.values())).device
    with torch.autocast(device.type, dtype=torch.bfloat16):
        return first_volumes(cfg, weights, batch, centres)


def focal_numbers(ref: dict, depths: dict, volumes: dict,
                  bf16: dict) -> dict:
    """Beside ``compare.train_numbers``, of the first step (the one whose
    weights are the same on both sides):
      - ``volume_vs_bf16``: the cost volumes' difference from the
        reference's, sqrt(sum over levels of ||v_l - v_ref_l||^2), over
        the same of the reference's bf16 volumes ``bf16``. The volumes of
        randomly drawn weights are correlations that cancel: bf16 moves
        them by 2-12 % and fp8 saturates every later number, but each
        seed's volume gap is its bf16 gap's, whatever the seed (PERF.md);
      - ``wta_gap``: over the pixels of levels 1 .. L-1 where the
        reference's largest probability leads its second by a log-ratio
        above ``LEAD``, the share at which ``depths`` ({l: (B, h_l, w_l)},
        the program's winner-take-all depths) is not the reference's own,
        farther than half the window's spacing; ``wta_led``, read, the
        share of pixels so led.
    ``volumes`` may hold fewer scenes than the reference (a fault that
    drops half the batch): the first ones are compared."""
    num = den = 0.0
    for l, v in volumes.items():
        want = ref["volumes"][l][:len(v)].to(v)
        num += float((v - want).norm()) ** 2
        den += float((bf16[l][:len(v)].to(v) - want).norm()) ** 2
    wrong = led = total = 0
    for l, (depth, lead, step) in ref["wta"].items():
        sure = lead > LEAD
        off = (depths[l].to(depth) - depth).abs() > 0.5 * step
        wrong += int((off & sure).sum())
        led += int(sure.sum())
        total += sure.numel()
    return {"volume_vs_bf16": math.sqrt(num) / max(math.sqrt(den), 1e-30),
            "wta_gap": wrong / max(led, 1), "wta_led": led / max(total, 1)}
