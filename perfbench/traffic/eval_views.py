"""Eval views: one client in a closed loop, one map after another.

Each map is the forward of ``eval_torch.py::Predictor`` on the next scene
of a pool staged on the device in set-up (``pool`` scenes of ``n_views``
images at ``img_wh``, focal ``focal``), followed by its ``depth_0`` and
``confidence_2`` copied to the host, as ``eval_torch.py`` holds them before
it writes its PFMs. A map's latency runs from the forward's call to its
maps on the host.

End-to-end: ``maps_per_s`` (maps finished over the window), ``map_ms_p95``
(the 95th percentile of every map's latency), ``peak_mem_gib``
(``max_memory_allocated`` over the window), ``setup_s``.

``correct``: after the window, a sample of its maps drawn from the seed
(each map with chance ``check_share``, at most ``check_max``, the last map
always) against the plain reference's maps of the same scenes in float32,
in units of the distance that bf16 rounding puts between the reference's
own maps, by the mean and by the depth's 99th percentile
(``compare.map_numbers``); and K1's launches, three a map.
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from perfbench import compare, faults, program, scenes, trace
from perfbench.harness import Ctx, GIB, Phases, result
from perfbench.reference.model import CascadeMVSNet as RefModel
from perfbench.reference.model import float32_exact


def run(ctx: Ctx) -> list[dict]:
    faults.plant(ctx.fault, ctx.config)
    return [_one(ctx, seed) for seed in ctx.seeds]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _one(ctx: Ctx, seed: int) -> dict:
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    cuda = torch.device(device).type == "cuda"
    V, focal, P = mix["n_views"], mix["focal"], mix["pool"]
    phases = Phases()
    weights = program.draw_weights(cfg, seed, device)
    predict = program.predictor(cfg, weights, device)
    phases.mark("weights and model")
    pool = [scenes.make_batch(seed, [i], ctx.img_wh, V, focal, cfg, device)
            for i in range(P)]
    phases.mark("scenes")
    dmin, dint = float(cfg["init_depth_min"]), float(cfg["depth_interval"])
    pick = random.Random(seed)
    kept: list[tuple[int, torch.Tensor, torch.Tensor]] = []
    last: list[tuple[int, torch.Tensor, torch.Tensor]] = []
    lat: list[float] = []

    def one_map(i: int, keep: bool) -> None:
        b = pool[i % P]
        t = time.perf_counter()
        depth, conf = predict(b["imgs"], b["proj_mats"], dmin, dint)
        depth, conf = depth[0].float().cpu(), conf[0].float().cpu()
        lat.append(time.perf_counter() - t)
        last[:] = [(i % P, depth, conf)]
        if keep:
            kept.append(last[0])

    for i in range(mix["warmup"]):
        one_map(i, False)
    _sync(device)
    phases.mark("warm-up maps")
    lat.clear()
    launches = program.launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - ctx.t_start
    phases.report(setup_s)

    def window(limit_s: float | None, units: int | None) -> int:
        n, t0 = 0, time.perf_counter()
        while (units is None and time.perf_counter() - t0 < limit_s) or \
                (units is not None and n < units):
            keep = pick.random() < mix["check_share"] and \
                len(kept) < mix["check_max"] - 1
            one_map(n, keep)
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
    if not kept or kept[-1] is not last[0]:
        kept.append(last[0])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    k1 = (program.launch_counts()["cost_volume_cuda"]
          - launches["cost_volume_cuda"]) / max(n, 1)
    del predict, pool
    if cuda:
        torch.cuda.empty_cache()

    numbers = _compare(ctx, seed, weights, kept)
    if cuda:                        # K1 once a level, no fallback
        numbers["k1_launch_gap"] = abs(k1 - cfg["levels"])
    table = compare.checks(numbers, ctx.cell["limits"], cuda)
    ok = compare.passed(table)
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] \
        if len(lat) >= 2 else lat[0]
    return result(
        metrics={"maps_per_s": n / wall, "map_ms_p95": p95 * 1e3,
                 "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        attempted=n, failed=0 if ok else len(kept), checks=table,
        peak_bytes=peak, trace=summary, units=n, numbers=numbers)


def _compare(ctx: Ctx, seed: int, weights: dict, kept: list) -> dict:
    """The worst sampled map's numbers against the reference: the
    reference's float32 maps of the same scene, and its maps with bf16
    rounding (``quant="bf16"``), whose distance from float32 is the yardstick
    of the seed's sensitivity."""
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    ref = RefModel(cfg).to(device)
    ref.load_state_dict(weights, strict=True)
    ref.eval()
    maps: dict[tuple[int, str | None], tuple] = {}
    quants = [None, "bf16"] + (["fp8"] if ctx.mode == "control" else [])
    worst: dict[str, float] = {}
    with float32_exact(), torch.no_grad():
        for scene in sorted({k[0] for k in kept}):
            b = scenes.make_batch(seed, [scene], ctx.img_wh, mix["n_views"],
                                  mix["focal"], cfg, device)
            for quant in quants:
                ref.set_quant(quant)
                out = ref(b["imgs"], b["proj_mats"], b["init_depth_min"],
                          b["depth_interval"])
                maps[scene, quant] = (out["depth_0"][0].cpu(),
                                      out["confidence_2"][0].cpu())
    for scene, depth, conf in kept:
        if ctx.mode == "control":
            depth, conf = maps[scene, "fp8"]
        nums = compare.map_numbers(depth, conf, *maps[scene, None],
                                   *maps[scene, "bf16"])
        for k, v in nums.items():
            worst[k] = compare.worse(worst.get(k), v)
    return worst
