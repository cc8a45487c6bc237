"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. require a CUDA device (there is no CPU path);
  2. print the toolchain: torch, CUDA, the card, nvidia-smi, nvcc, triton;
  3. build the kernels from casmvsnet_pl_tpu_torch/csrc/ (one nvcc call);
  4. hold the cost-volume kernel (K1) against its plain PyTorch version at
     the three cascade level shapes (B=1), in f32 (<= 1e-4 abs) and bf16
     (<= 1 bf16 ulp of the plain f32 result), for variance and groupwise
     (G=8);
  5. run the inference forward through ``entry``: f32 with the kernel
     against f32 with the plain cost volume (< 0.05 mm on depth_0), and the
     bf16 main path, counting exactly one K1 launch per level;
  6. time bf16 forwards at B=1 and B=4 with CUDA events;
  7. (below, after phase 26) print the kernels' JSON line (launches per
     main path; what each time covers; bounds), then {"ok": true,
     "device": ...} last;
  8. hold the backward kernel (K2) against its plain PyTorch version at the
     three level shapes at B=2, variance and groupwise (G=8), f32
     (<= 1e-5 abs + 1e-5 rel) and bf16 (<= 2 bf16 ulps of the rounded plain
     f32 result, + 1e-5 abs), and the autograd Function's gradient against
     autograd through the plain forward at L2 (f32);
  9. one f32 SGD train step through ``train_entry`` with the kernels and
     one with the plain cost volume, from the same state and batch: loss
     within rtol 1e-5, every gradient leaf within relative L2 1e-3 (the
     prob convs' biases, whose exact gradient is 0, against their weights'
     gradient norm; cuDNN deterministic, so that the cost volume is the
     only difference), and
     exactly 3 K1 + 3 K2 launches in the kernel step, none in the plain;
 10. the training main path at full width: bf16, 640x512x3, B=2, Adam
     lr 1e-3, 20 steps on one batch, counting 3 K1 + 3 K2 launches a step;
     every loss finite and the last below the first;
 11. time the bf16 train step (stages, step, samples/s, peak memory) with
     CUDA events.

The quad configuration (``sampling="quad"``: packed-quad rows reduced by
the cost epilogue kernels, TPU kernels #3-#6):
 12. hold #3 (variance) and #5 (groupwise, G=8) against their plain
     versions on the rows and weights that ``quad_rows`` builds from the
     plane scene, at the three level shapes (B=1): f32 <= 1e-5 abs, bf16
     <= 1 bf16 ulp of the plain f32 result;
 13. hold #4 and #6 against theirs at B=2 on d ref, d rows and d ws: f32
     <= 1e-5 abs + 1e-5 rel, bf16 <= 2 bf16 ulps of the rounded plain
     result + 1e-5;
 14. the f32 quad inference forward through ``entry(sampling="quad")``
     against the default path (< 0.05 mm on depth_0), then the bf16 quad
     forward: 3 #3 launches and no K1;
 15. one f32 SGD step through ``train_entry(sampling="quad")`` with the
     kernels and one with the plain quad route (autograd through
     ``plain_quad_cost_volume``), as phase 9: 3 #3 + 3 #4 launches and no
     K1/K2;
 16. 10 bf16 Adam steps with sampling="quad" at 640x512x3, B=2, as phase
     10;
 17. the groupwise (G=8) quad configuration: one bf16 forward (3 #5) and
     two bf16 Adam steps (3 #5 + 3 #6 a step);
 18. time the bf16 quad forward (B=1, 4) and train step, then every
     kernel (K1, K2, #3-#6) against its plain version per level, in turns
     plain/kernel/kernel/plain, each beside its bound;
 19. profile the bf16 forward (B=1) and train step of the default and the
     quad configurations: device time by kernel name (``torch.profiler``).

The packed-quad warp (``warp_src_quad_batched``: ``grid_sample_quad``,
whose 4-tap reduce is TPU kernel #7 and its VJP #8):
 20. hold #7 and #8 against their plain versions on one source view's rows
     and weights from ``quad_rows`` at the three level shapes (B=2), and on
     a prefix of N = 100003 rows (no multiple of any block size): #7 out
     <= 1e-5 abs (f32 and bf16 rows); #8 d rows exact (f32) or within 1
     bf16 ulp (bf16), d w <= 1e-5 abs + 1e-5 rel;
 21. the warp path at full width: both source views at each level (C
     32/16/8, D 48/32/8, B=2), the plane scene's projections and depth
     windows. f32: the forward against ``grid_sample_batched`` at the same
     coordinates (<= 1e-5 abs), and the gradient of sum(out * G) for the
     source features (through ``pack_quad``), ``proj_mats`` and
     ``depth_values`` against autograd through the plain route (each leaf
     within relative L2 1e-4). Then the bf16 main path: forward and
     backward finite, exactly 6 #7 and 6 #8 launches and no other kernel;
 22. time #7 and #8 per level (bf16 rows of one source view, B=2) against
     their plain versions beside their bounds, and #7's library call, a
     batched ``torch.matmul`` of w (N, 1, 4) by the rows upcast to f32
     (N, 4, C); then profile the bf16 warp path of phase 21.

The probes (``casmvsnet_pl_tpu_torch/probes``: the card's counterparts of
the TPU probes, kernels #9-#13), each probe's ``main`` path at the probe's
full-width shapes, every configuration checked against its plain version
and timed in turns beside its bound; one "probes" path whose launches are
counted over phases 23-26:
 23. #13 (``probes/gather.py``): the three row-gather forms (ldg, cp_async,
     bulk) and the lane gather at the TPU probe's shapes, the probe's five
     gather forms in PyTorch equal, then the forms at the quad route's own
     gather (``quad_rows`` at B=1, 3 levels) beside ``index_select``; and
     #11 (``probes/epi3.py``): the lane-prefix copy at 1024 and 8192 rows
     per block beside ``rows[..., :C].contiguous()``. Bit-exact;
 24. #9 (``probes/epi2.py``): the variance epilogue with dblk in {1, 4, 8,
     D} depths per thread at the probe's L1 and L2 configs, beside #3;
 25. #10 (``probes/epi3.py``): the V=3 variance epilogue at 64-1024
     threads per block, beside #3. #9/#10: f32 <= 1e-5 abs, bf16 <= 1 bf16
     ulp of the plain f32 result;
 26. #12 (``probes/epi5.py``): the transposed patch epilogue per level and
     channel split (f32 out <= 1e-5 abs), and the probe's four samplers of
     one view (quad, validfold, tfma, the kernel) in ms and ns per sample;
 27. the host's cost of a launch: the time to enqueue one call
     (``probes/host.py``) of the lane gather, the ldg row gather, K1 and K2
     at small shapes, beside ``index_select`` at the gathers' probe shapes
     and the allocations K1 and K2 make (``new_empty``, ``new_zeros``).

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and the float32 operations of
the function it computes over 67 TFLOP/s, the H100 SXM's published rates,
counted from this run's shapes (the lane-prefix copy's bytes are the
prefixes it must read and write, not the whole rows).
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import torch

from casmvsnet_pl_tpu_torch.probes.common import (bf16_ulp, bound, cuda_ms,
                                                  cv_work, default_levels,
                                                  epilogue_work, plane_levels)

DEVICE = "cuda"
IMG_WH = (640, 512)
F32_TOL = 1e-4          # abs, features in [0, 1): coordinates reach ~640 px
DEPTH_TOL_MM = 0.05     # tests/test_torch_parity.py
# K2 adds source-view shares with atomics, in an order that changes from run
# to run: f32 agrees with the plain backward to rounding; bf16 within 2 ulps
# of the rounded plain result, or within the f32 bound where cancellation
# leaves a value whose ulp is below the summation-order noise.
BWD_TOL = 1e-5
GRAD_REL_TOL = 1e-3     # train step, every gradient leaf, relative L2
TRAIN_STEPS = 20
# #3-#6 write every element once, with no atomics: f32 agrees with the
# plain versions to the order of their sums
EPI_TOL = 1e-5
# #7/#8 write every element once: f32 out and d rows are the plain
# versions' products and sums in their order; d w sums in another order
TAP_TOL = 1e-5
TAP_ODD_N = 100003
WARP_REL_TOL = 1e-4     # warp gradient leaves, relative L2
QUAD_TRAIN_STEPS = 10
G8_TRAIN_STEPS = 2

# kernel launches of one forward and of one train step, per configuration
DEFAULT_FWD = {"cost_volume_cuda": 3}
DEFAULT_STEP = {"cost_volume_cuda": 3, "cost_volume_bwd_cuda": 3}
QUAD_FWD = {"variance_epilogue_cuda": 3}
QUAD_STEP = {"variance_epilogue_cuda": 3, "variance_epilogue_bwd_cuda": 3}
G8_FWD = {"groupwise_epilogue_cuda": 3}
G8_STEP = {"groupwise_epilogue_cuda": 3, "groupwise_epilogue_bwd_cuda": 3}
# forward and backward of both source views at each of the three levels
WARP_PATH = {"tap_reduce_cuda": 6, "tap_reduce_bwd_cuda": 6}
# the probes' kernels (TPU kernels #9-#13), each launched on the probes path
PROBE_KERNELS = ("lane_prefix_copy_cuda", "row_gather_ldg_cuda",
                 "row_gather_cp_async_cuda", "row_gather_bulk_cuda",
                 "lane_gather_cuda", "variance_dblk_cuda", "variance_v3_cuda",
                 "patch_epilogue_t_cuda")


def levels():
    """(level, C, D, h, w) of the default config, coarse to fine."""
    return default_levels(IMG_WH)


def toolchain() -> str:
    """Print the toolchain report; return nvidia-smi's name and power limit."""
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    from casmvsnet_pl_tpu_torch.kernels.cost_volume import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        print("triton:", triton.__version__)
    except ImportError as e:
        print("triton: not importable:", e)
    return card


def build_kernel(kernel) -> None:
    t0 = time.perf_counter()
    kernel.build()
    log = kernel.build_log
    print(log, file=sys.stderr)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"build: {time.perf_counter() - t0:.3f} s, {len(regs)} kernels "
          f"compiled, registers max {max(regs, default='n/a (cached)')}, "
          f"spill stores max {max(spills, default='n/a (cached)')} bytes")


def level_inputs(batch: int = 1):
    """Per level: (proj (B, 2, 3, 4), depth windows (B, D, h, w)), built
    the way the cascade builds them, on the plane scene, repeated B
    times."""
    return plane_levels(DEVICE, batch, IMG_WH)


def all_kernels() -> dict:
    """Every kernel wrapper of the port by name."""
    from casmvsnet_pl_tpu_torch import kernels as k
    return {n: getattr(k, n) for n in (
        "cost_volume_cuda", "cost_volume_bwd_cuda", "variance_epilogue_cuda",
        "variance_epilogue_bwd_cuda", "groupwise_epilogue_cuda",
        "groupwise_epilogue_bwd_cuda", "tap_reduce_cuda",
        "tap_reduce_bwd_cuda") + PROBE_KERNELS}


def reset_counts() -> None:
    for kernel in all_kernels().values():
        kernel.launches = 0


def read_counts() -> dict:
    return {n: k.launches for n, k in all_kernels().items()}


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as ``want`` says (0 where unnamed)."""
    full = {n: want.get(n, 0) for n in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def scaled(want: dict, n: int) -> dict:
    return {name: count * n for name, count in want.items()}


def check_kernel(kernel, plain, inputs) -> float:
    """Kernel vs plain at every level shape; returns the max f32 abs error."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    worst = 0.0
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        feats = torch.rand((1, 3, h, w, C), generator=g, device=DEVICE)
        for groups in (1, 8):
            name = "variance" if groups == 1 else f"groupwise{groups}"
            k32 = kernel(feats, proj, dv, groups)
            p32 = plain(feats, proj, dv, groups)
            err = (k32 - p32).abs().max().item()
            worst = max(worst, err)
            fb = feats.to(torch.bfloat16)
            kb = kernel(fb, proj, dv, groups)
            pb = plain(fb.float(), proj, dv, groups).to(torch.bfloat16)
            ulps = ((kb.float() - pb.float()).abs()
                    / bf16_ulp(pb)).max().item()
            ndiff = (kb != pb).sum().item()
            print(f"kernel-check L{l} {name} out={tuple(k32.shape)} "
                  f"f32 max_abs_err={err!r} (bound {F32_TOL}) "
                  f"bf16 max_ulps={ulps!r} (bound 1) "
                  f"bf16 elements differing={ndiff}/{kb.numel()}")
            if not err <= F32_TOL:
                raise AssertionError(f"L{l} {name} f32 error {err}")
            if not ulps <= 1.0:
                raise AssertionError(f"L{l} {name} bf16 error {ulps} ulp")
    return worst


def check_outputs(depth, conf, batch: int) -> None:
    W, H = IMG_WH
    if tuple(depth.shape) != (batch, H, W) or tuple(conf.shape) != (
            batch, H // 4, W // 4):
        raise AssertionError("wrong output shapes")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise AssertionError("non-finite outputs")
    if not (conf.min() >= 0 and conf.max() <= 1):
        raise AssertionError("confidence outside [0, 1]")


def sharpened_f32_forward(entry, sampling: str = "auto"):
    """(fn, args) of the f32 forward, with the softmax over depth sharpened
    so that depth_0 follows the cost volume."""
    fn, args = entry(DEVICE, torch.float32, img_wh=IMG_WH, sampling=sampling)
    with torch.no_grad():
        for l in range(3):
            getattr(args[0], f"cost_reg_{l}").prob.weight *= 30.0
    return fn, args


def counted(run, want: dict, what: str):
    """``run()`` between a reset and a read of the launch counts, which must
    be ``want``; returns its result."""
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    expect_counts(read_counts(), want, what)
    return out


def forward_main_path(entry, want: dict, label: str, **kw) -> dict:
    """One bf16 forward at B=1 through ``entry(**kw)``: its outputs checked
    and its launches exactly ``want``; returns the launches."""
    fn, args = entry(DEVICE, torch.bfloat16, img_wh=IMG_WH, **kw)
    reset_counts()
    depth, conf = fn(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"forward bf16{label} main path: launches {counts}, depth_0 "
          f"{tuple(depth.shape)} range [{depth.min().item()!r}, "
          f"{depth.max().item()!r}], confidence_2 {tuple(conf.shape)} range "
          f"[{conf.min().item()!r}, {conf.max().item()!r}]")
    expect_counts(counts, want, f"bf16 forward{label}")
    check_outputs(depth, conf, 1)
    return counts


def check_forward(entry, plain) -> dict:
    """f32 kernel vs plain forward, then the bf16 main path; returns the
    launches counted over the main path's run."""
    fn, args = sharpened_f32_forward(entry)
    d_k, c_k = counted(lambda: fn(*args), DEFAULT_FWD, "f32 forward")
    d_p, c_p = counted(lambda: fn(*args, cost_volume=plain), {},
                       "f32 plain forward")
    dd = (d_k - d_p).abs().max().item()
    dc = (c_k - c_p).abs().max().item()
    print(f"forward f32 kernel vs plain: max|d depth_0|={dd!r} mm "
          f"(bound {DEPTH_TOL_MM}), max|d confidence_2|={dc!r}, "
          f"depth_0 range [{d_k.min().item()!r}, {d_k.max().item()!r}]")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 depth_0 kernel vs plain {dd} mm")
    del fn, args
    return forward_main_path(entry, DEFAULT_FWD, "")


def check_quad_forward(entry) -> dict:
    """The f32 quad forward against the default path, then the bf16 quad
    main path; returns the latter's launches."""
    outs = {}
    for sampling, want in (("auto", DEFAULT_FWD), ("quad", QUAD_FWD)):
        fn, args = sharpened_f32_forward(entry, sampling)
        outs[sampling] = counted(lambda: fn(*args), want,
                                 f"f32 forward sampling={sampling}")
        del fn, args
    dd = (outs["quad"][0] - outs["auto"][0]).abs().max().item()
    dc = (outs["quad"][1] - outs["auto"][1]).abs().max().item()
    print(f"forward f32 sampling=quad vs default: max|d depth_0|={dd!r} mm "
          f"(bound {DEPTH_TOL_MM}), max|d confidence_2|={dc!r}")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 quad depth_0 vs default {dd} mm")
    return forward_main_path(entry, QUAD_FWD, " sampling=quad",
                             sampling="quad")


def time_forward(entry, card, label: str = "", **kw) -> None:
    """bf16 inference forward at B=1 and 4."""
    for batch in (1, 4):
        fn, args = entry(DEVICE, torch.bfloat16, batch=batch, img_wh=IMG_WH,
                         **kw)
        fn(*args)
        ms = cuda_ms(lambda: fn(*args), 10)
        print(f"timing forward{label} bf16 B={batch} {IMG_WH[0]}x"
              f"{IMG_WH[1]}x3: {ms!r} ms/forward, "
              f"{batch * 1000.0 / ms!r} maps/s [{card}]")
        del fn, args


def check_bwd(kernel_bwd, plain_bwd, inputs2) -> float:
    """K2 vs its plain version at every level shape, B=2; returns the max
    f32 abs error."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    worst = 0.0
    for l, C, D, h, w in levels():
        proj, dv = inputs2[l]
        feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE)
        for groups in (1, 8):
            name = "variance" if groups == 1 else f"groupwise{groups}"
            go = torch.randn((2, D, h, w, C if groups == 1 else groups),
                             generator=g, device=DEVICE)
            k32 = kernel_bwd(feats, proj, dv, go, groups)
            p32 = plain_bwd(feats, proj, dv, go, groups)
            err = (k32 - p32).abs()
            worst = max(worst, err.max().item())
            f32_ok = bool((err <= BWD_TOL + BWD_TOL * p32.abs()).all())
            fb, gb = feats.to(torch.bfloat16), go.to(torch.bfloat16)
            kb = kernel_bwd(fb, proj, dv, gb, groups).float()
            pb = plain_bwd(fb.float(), proj, dv, gb.float(), groups
                           ).to(torch.bfloat16).float()
            eb = (kb - pb).abs()
            ulps = eb / bf16_ulp(pb)
            bf16_ok = bool((eb <= 2 * bf16_ulp(pb) + BWD_TOL).all())
            print(f"bwd-check L{l} {name} feats={tuple(feats.shape)} "
                  f"f32 max_abs_err={err.max().item()!r} max|grad|="
                  f"{p32.abs().max().item()!r} (bound {BWD_TOL} + "
                  f"{BWD_TOL} rel) bf16 max_ulps={ulps.max().item()!r} "
                  f"elements over 2 ulps={(ulps > 2).sum().item()}/"
                  f"{kb.numel()} max_abs_err={eb.max().item()!r}")
            if not f32_ok:
                raise AssertionError(f"L{l} {name} K2 f32 error {err.max()}")
            if not bf16_ok:
                raise AssertionError(f"L{l} {name} K2 bf16 error")
    # the autograd Function (K1 forward, K2 backward) at L2, f32
    from casmvsnet_pl_tpu_torch.ops import (build_cost_volume,
                                            plain_cost_volume)
    l, C, D, h, w = levels()[0]
    proj, dv = inputs2[l]
    feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE,
                       requires_grad=True)
    out = build_cost_volume(feats, proj, dv)
    go = torch.randn(out.shape, generator=g, device=DEVICE)
    got, = torch.autograd.grad(out, feats, go)
    ref, = torch.autograd.grad(plain_cost_volume(feats, proj, dv), feats, go)
    err = (got - ref).abs().max().item()
    print(f"autograd Function vs plain autograd L{l} f32: max_abs_err="
          f"{err!r}")
    if not bool(((got - ref).abs() <= BWD_TOL + BWD_TOL * ref.abs()).all()):
        raise AssertionError(f"Function gradient error {err}")
    return worst


def check_train_step(train_entry, plain, want: dict,
                     sampling: str = "auto") -> None:
    """f32 SGD step with the kernels against one with ``plain`` as the cost
    volume, from the same state and batch; the kernel step launches
    exactly ``want``, the plain step nothing."""
    runs = {}
    # cuDNN's default conv backward sums in a run-dependent order, which
    # moves some leaves by ~4e-3 between two identical plain steps; its
    # deterministic algorithms leave the cost volume as the only difference.
    torch.backends.cudnn.deterministic = True
    for name, cv in (("kernel", None), ("plain", plain)):
        trainer, state, batch = train_entry(
            DEVICE, torch.float32, img_wh=IMG_WH, optimizer="sgd", lr=1e-2,
            cost_volume=cv, sampling=sampling)
        reset_counts()
        state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        runs[name] = (float(logs["train/loss"]),
                      {n: p.grad.double() for n, p in
                       state.model.named_parameters()}, read_counts())
        del trainer, state, batch
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (lk, gk, nk), (lp, gp, npl) = runs["kernel"], runs["plain"]

    def scale(n):
        # The prob conv's bias gets no gradient in exact arithmetic (the
        # softmax over depth ignores a constant shift), so its leaf is held
        # against the scale of the same conv's weight gradient.
        return gp[n.replace("prob.bias", "prob.weight")].norm()

    worst = max(((gk[n] - gp[n]).norm() / scale(n)).item() for n in gp)
    print(f"train step f32 sampling={sampling} kernel vs plain: loss {lk!r} "
          f"vs {lp!r}, worst gradient leaf relative L2 {worst!r} (bound "
          f"{GRAD_REL_TOL}), launches kernel step {nk}, plain step {npl}")
    expect_counts(nk, want, f"sampling={sampling} kernel step")
    expect_counts(npl, {}, f"sampling={sampling} plain step")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"loss {lk} vs {lp}")
    if not worst <= GRAD_REL_TOL:
        raise AssertionError(f"gradient leaf relative error {worst}")


def train_main_path(train_entry, card, steps: int, want_per_step: dict,
                    **kw):
    """bf16 Adam at full width on one batch through ``train_entry(**kw)``;
    every loss finite, the last below the first, and the launches exactly
    ``want_per_step`` a step. Returns (trainer, state, batch, launches)."""
    trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH, **kw)
    reset_counts()
    losses = []
    for _ in range(steps):
        state, logs = trainer.train_step(state, batch)
        losses.append(float(logs["train/loss"]))
    torch.cuda.synchronize()
    counts = read_counts()
    W, H = IMG_WH
    label = "".join(f" {k}={v}" for k, v in kw.items())
    print(f"train bf16{label} {W}x{H}x3 B=2 adam lr 1e-3, {steps} steps on "
          f"one batch: losses {losses!r}; launches {counts} [{card}]")
    expect_counts(counts, scaled(want_per_step, steps), f"train{label}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    return trainer, state, batch, counts


def time_train(trainer, state, batch, card, label: str = "") -> None:
    """bf16 train step: stage times, whole step, peak memory."""
    from casmvsnet_pl_tpu_torch.engine import model_batch_args
    from casmvsnet_pl_tpu_torch.losses import sl1_loss

    model, opt = state.model, state.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stages = []
    for _ in range(5):
        ev[0].record()
        with trainer._autocast():
            outs = model(*model_batch_args(batch))
        loss = sl1_loss(outs, batch["depths"], batch["masks"])
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, upd = (sum(x) / len(stages) for x in zip(*stages))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: trainer.train_step(state, batch), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"timing train step{label} bf16 B=2 {IMG_WH[0]}x{IMG_WH[1]}x3 adam: "
          f"{ms!r} ms/step, {2 * 1000.0 / ms!r} samples/s, peak memory "
          f"{peak!r} GiB; stages (mean of 5): forward+loss {fwd!r} ms, "
          f"backward {bwd!r} ms, optimizer {upd!r} ms [{card}]")


# --- the quad configuration: TPU kernels #3-#6 ------------------------------

def epilogues():
    """{groups: (kernel, plain, kernel bwd, plain bwd)} for variance (#3/#4)
    and groupwise G=8 (#5/#6); every function takes (..., groups)."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce
    return {
        1: (k.variance_epilogue_cuda,
            lambda r, rows, ws, G: ce.plain_variance_epilogue(r, rows, ws),
            k.variance_epilogue_bwd_cuda,
            lambda r, rows, ws, g, G: ce.plain_variance_epilogue_bwd(
                r, rows, ws, g)),
        8: (k.groupwise_epilogue_cuda, ce.plain_groupwise_epilogue,
            k.groupwise_epilogue_bwd_cuda, ce.plain_groupwise_epilogue_bwd)}


def quad_level_rows(inputs, batch: int, seed: int):
    """Per level: (ref, rows, ws) that ``quad_rows`` builds from random
    features (B, 3, h, w, C) in [0, 1) on the plane scene's rig."""
    from casmvsnet_pl_tpu_torch.ops import quad_rows
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        feats = torch.rand((batch, 3, h, w, C), generator=g, device=DEVICE)
        yield (l, C, D, h, w), quad_rows(feats, proj, dv)[:3]


def check_epilogues(inputs) -> dict:
    """#3 and #5 against their plain versions at every level shape, B=1;
    returns the max f32 abs error by kernel name."""
    worst = {}
    for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(inputs, 1, 4):
        rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
        for groups, (kernel, plain, _, _) in epilogues().items():
            k32 = kernel(ref, rows, ws, groups)
            err = (k32 - plain(ref, rows, ws, groups)).abs().max().item()
            worst[kernel.name] = max(worst.get(kernel.name, 0.0), err)
            kb = kernel(rb, rowsb, ws, groups)
            pf = plain(rb.float(), rowsb.float(), ws, groups)
            ulps = ((kb.float() - pf).abs() / bf16_ulp(pf)).max().item()
            print(f"epilogue-check L{l} {kernel.name} rows="
                  f"{tuple(rows.shape)} out={tuple(k32.shape)} f32 "
                  f"max_abs_err={err!r} (bound {EPI_TOL}) bf16 max_ulps="
                  f"{ulps!r} (bound 1)")
            if not err <= EPI_TOL:
                raise AssertionError(f"L{l} {kernel.name} f32 error {err}")
            if not ulps <= 1.0:
                raise AssertionError(f"L{l} {kernel.name} bf16 {ulps} ulp")
        del ref, rows, ws, rb, rowsb
    return worst


def check_epilogues_bwd(inputs2) -> dict:
    """#4 and #6 against their plain versions at every level shape, B=2, on
    d ref, d rows and d ws; returns the max f32 abs error by kernel name."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst = {}
    for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(inputs2, 2, 6):
        rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
        for groups, (_, _, kernel, plain) in epilogues().items():
            go = torch.randn((2, D, h * w, C if groups == 1 else groups),
                             generator=g, device=DEVICE)
            got = kernel(ref, rows, ws, go, groups)
            want = plain(ref, rows, ws, go, groups)
            errs, over = [], []
            for a, b in zip(got, want):
                e = (a - b).abs()
                errs.append(e.max().item())
                if not bool((e <= EPI_TOL + EPI_TOL * b.abs()).all()):
                    raise AssertionError(f"L{l} {kernel.name} f32 error")
            del got, want
            gb = go.to(torch.bfloat16)
            got = kernel(rb, rowsb, ws, gb, groups)
            want = plain(rb.float(), rowsb.float(), ws, gb.float(), groups)
            for a, b in zip(got, want):
                b = b.to(a.dtype).float()
                e = (a.float() - b).abs()
                over.append((e > 2 * bf16_ulp(b) + EPI_TOL).sum().item())
            del got, want
            worst[kernel.name] = max([worst.get(kernel.name, 0.0)] + errs)
            print(f"epilogue-bwd-check L{l} {kernel.name} rows="
                  f"{tuple(rows.shape)} f32 max_abs_err d ref/d rows/d ws="
                  f"{errs!r} (bound {EPI_TOL} + {EPI_TOL} rel) bf16 elements "
                  f"over 2 ulps + {EPI_TOL}: {over}")
            if any(over):
                raise AssertionError(f"L{l} {kernel.name} bf16 error")
        del ref, rows, ws, rb, rowsb
    return worst


# --- kernel timing ----------------------------------------------------------

def time_level(sums: dict, name: str, label: str, run_k, run_p, iters,
               work, card, note: str = "") -> None:
    """Time a kernel against its plain version on one level's inputs, in
    turns plain/kernel/kernel/plain (``iters`` = calls per turn, kernel and
    plain), print both beside the bound of ``work`` = (bytes, float32
    operations), and add the times and the work into ``sums[name]``."""
    k_iters, p_iters = iters
    p1 = cuda_ms(run_p, p_iters)
    k1 = cuda_ms(run_k, k_iters)
    k2 = cuda_ms(run_k, k_iters)
    p2 = cuda_ms(run_p, p_iters)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    nbytes, flops = work
    b_ms, by = bound(nbytes, flops)
    print(f"timing {name} {label}: kernel {k_ms!r} ms ({k1!r}, {k2!r}), "
          f"plain {p_ms!r} ms ({p1!r}, {p2!r}); {note}bound {b_ms!r} ms by "
          f"{by} ({nbytes / 1e6!r} MB, {flops / 1e9!r} GFLOP) -> "
          f"{nbytes / 1e9 / k_ms!r} TB/s, {100 * b_ms / k_ms!r} % of bound "
          f"[{card}]")
    acc = sums.get(name, (0.0, 0.0, 0.0, 0.0))
    sums[name] = tuple(a + b for a, b in zip(acc, (k_ms, p_ms, nbytes,
                                                    flops)))


def time_kernels(inputs, inputs2, card) -> dict:
    """Every kernel against its plain version per level, bf16: K1 and #3/#5
    at B=1, K2 and #4/#6 at B=2 (K1/K2 variance, the epilogues variance and
    G=8). Returns by wrapper name the sums over the levels of the kernel
    and plain times, and the bound of the summed work with what sets it."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import (plain_cost_volume,
                                            plain_cost_volume_bwd)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    sums = {}
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        fb = torch.rand((1, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        out_mb = D * h * w * C * 2 / 1e6
        time_level(sums, "cost_volume_cuda", f"L{l} bf16 (1,{D},{h},{w},{C})",
                   lambda: k.cost_volume_cuda(fb, proj, dv),
                   lambda: plain_cost_volume(fb, proj, dv), (50, 5),
                   cv_work(1, 3, D, h, w, C, 1, 2), card,
                   f"output write {out_mb!r} MB; ")
        proj, dv = inputs2[l]
        fb = torch.rand((2, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        gb = torch.randn((2, D, h, w, C), generator=g,
                         device=DEVICE).to(torch.bfloat16)
        adds = 2 * D * h * w * 2 * 4 * C
        time_level(sums, "cost_volume_bwd_cuda",
                   f"L{l} bf16 feats (2,3,{h},{w},{C}) D={D}",
                   lambda: k.cost_volume_bwd_cuda(fb, proj, dv, gb),
                   lambda: plain_cost_volume_bwd(fb, proj, dv, gb), (20, 3),
                   cv_work(2, 3, D, h, w, C, 1, 2, backward=True), card,
                   f"{adds / 1e9!r} G f32 tap shares (before runs); ")
    for batch, data in ((1, inputs), (2, inputs2)):
        backward = batch == 2
        for (l, C, D, h, w), (ref, rows, ws) in quad_level_rows(data, batch,
                                                                8 + batch):
            rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
            del ref, rows
            S = rowsb.shape[1]
            for groups, (kf, pf, kb, pb) in epilogues().items():
                if backward:
                    go = torch.randn((batch, D, h * w,
                                      C if groups == 1 else groups),
                                     generator=g, device=DEVICE).to(
                                         torch.bfloat16)
                    kernel, plain, args = kb, pb, (rb, rowsb, ws, go, groups)
                else:
                    kernel, plain, args = kf, pf, (rb, rowsb, ws, groups)
                time_level(sums, kernel.name,
                           f"L{l} bf16 rows {tuple(rowsb.shape)}",
                           lambda: kernel(*args), lambda: plain(*args),
                           (20, 3), epilogue_work(batch, S, D, h * w, C,
                                                  groups, 2, backward), card)
            del rb, rowsb, ws
    return {name: (k_ms, p_ms, *bound(nbytes, flops))
            for name, (k_ms, p_ms, nbytes, flops) in sums.items()}


def profile(fn, label: str, card, iters: int = 3) -> None:
    """Device time per call of ``fn`` by kernel name over ``iters`` calls
    (``torch.profiler``, after one warm-up call), the 12 largest and the
    rest, and the busy share: summed kernel time over the wall time of the
    calls with the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    times = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key[:100]
        ms, n = times.get(name, (0.0, 0))
        times[name] = (ms + us / 1e3 / iters, n + e.count // iters)
    total = sum(ms for ms, _ in times.values())
    print(f"profile{label}: wall {wall!r} ms per call (profiler on), kernel "
          f"time {total!r} ms, busy {100 * total / wall!r} %, "
          f"{len(times)} kernel names [{card}]")
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:12]:
        print(f"  {ms!r} ms {100 * ms / max(total, 1e-9)!r} % x{n} {name}")
    rest = sum(ms for _, (ms, _) in ranked[12:])
    print(f"  {rest!r} ms in the other {max(len(ranked) - 12, 0)} names")


def profile_paths(entry, train_entry, card) -> None:
    """Phase 19: the default and quad bf16 forward (B=1) and train step."""
    for sampling in ("auto", "quad"):
        fn, args = entry(DEVICE, img_wh=IMG_WH, sampling=sampling)
        profile(lambda: fn(*args), f" forward bf16 B=1 sampling={sampling}",
                card)
        del fn, args
        trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH,
                                            sampling=sampling)
        profile(lambda: trainer.train_step(state, batch),
                f" train step bf16 B=2 sampling={sampling}", card)
        del trainer, state, batch
        torch.cuda.empty_cache()


# --- the packed-quad warp: TPU kernels #7/#8 --------------------------------

def tap_level_rows(inputs2, seed: int):
    """Per level: one source view's rows (N, 4C) f32 and weights (N, 4) f32,
    N = 2 D h w, that ``quad_rows`` builds at B=2."""
    for (l, C, D, h, w), (_, rows, ws) in quad_level_rows(inputs2, 2, seed):
        yield ((l, C, D, h, w), rows[:, 0].reshape(-1, 4 * C),
               ws[:, 0].reshape(-1, 4))
        del rows, ws


def check_tap_reduce(inputs2) -> dict:
    """#7 and #8 against their plain versions at every level shape and on a
    prefix of TAP_ODD_N rows; returns the max f32 abs error by name."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr
    g = torch.Generator(device=DEVICE).manual_seed(14)
    worst = {}
    for (l, C, D, h, w), rows, ws in tap_level_rows(inputs2, 15):
        for n in (rows.shape[0], TAP_ODD_N):
            go = torch.randn((n, C), generator=g, device=DEVICE)
            for dtype in (torch.float32, torch.bfloat16):
                r, w4 = rows[:n].to(dtype), ws[:n]
                e_out = (k.tap_reduce_cuda(r, w4)
                         - tr.plain_tap_reduce(r, w4)).abs().max().item()
                (d_rows, d_w), (p_rows, p_w) = (
                    k.tap_reduce_bwd_cuda(r, w4, go),
                    tr.plain_tap_reduce_bwd(r, w4, go))
                e_rows = (d_rows.float() - p_rows.float()).abs()
                ulps = (e_rows / bf16_ulp(p_rows)).max().item()
                e_rows = e_rows.max().item()
                e_w = (d_w - p_w).abs()
                w_ok = bool((e_w <= TAP_TOL + TAP_TOL * p_w.abs()).all())
                e_w = e_w.max().item()
                bf16 = dtype == torch.bfloat16
                print(f"tap-reduce-check L{l} {'bf16' if bf16 else 'f32'} "
                      f"rows ({n}, {4 * C}): out max_abs_err={e_out!r} "
                      f"(bound {TAP_TOL}); d rows max_abs_err={e_rows!r} "
                      f"max_ulps={ulps!r} (bound {'1 ulp' if bf16 else 0}); "
                      f"d w max_abs_err={e_w!r} (bound {TAP_TOL} + "
                      f"{TAP_TOL} rel)")
                if not e_out <= TAP_TOL:
                    raise AssertionError(f"L{l} #7 error {e_out}")
                if not (ulps <= 1.0 if bf16 else e_rows == 0.0):
                    raise AssertionError(f"L{l} #8 d rows error {e_rows}")
                if not w_ok:
                    raise AssertionError(f"L{l} #8 d w error {e_w}")
                if not bf16:
                    for name, e in (("tap_reduce_cuda", e_out),
                                    ("tap_reduce_bwd_cuda", max(e_rows,
                                                                e_w))):
                        worst[name] = max(worst.get(name, 0.0), e)
                del d_rows, d_w, p_rows, p_w, r
        del rows, ws
    return worst


def warp_views(inputs2, dtype, seed: int):
    """For each level and source view v: (level, leaves, G), with leaves
    the source features (2, h, w, C) of view v, its projections (2, 3, 4)
    and the depth windows (2, D, h, w), all requiring grad, and G a seeded
    gradient of the warp's output."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    for lvl in levels():
        l, C, D, h, w = lvl
        proj, dv = inputs2[l]
        feats = torch.rand((2, 3, h, w, C), generator=g, device=DEVICE)
        for v in (1, 2):
            leaves = [feats[:, v].to(dtype).requires_grad_(True),
                      proj[:, v - 1].clone().requires_grad_(True),
                      dv.clone().requires_grad_(True)]
            G = torch.randn((2, D, h, w, C), generator=g,
                            device=DEVICE).to(dtype)
            yield lvl, leaves, G


def check_warp(inputs2) -> None:
    """Phase 21, f32: the warp through #7/#8 against the plain sampler
    forward and against autograd through its plain route backward."""
    from casmvsnet_pl_tpu_torch.ops import (grid_sample_batched, pack_quad,
                                            plain_grid_sample_quad,
                                            project_to_src,
                                            warp_src_quad_batched)
    reset_counts()
    for (l, C, D, h, w), leaves, G in warp_views(inputs2, torch.float32, 16):
        src, P, d = leaves
        out = warp_src_quad_batched(pack_quad(src), P, d, h, w)
        got = torch.autograd.grad(out, leaves, G)
        xy = project_to_src(P, d, h, w)
        with torch.no_grad():
            e_fwd = (out - grid_sample_batched(src, xy)).abs().max().item()
        plain = plain_grid_sample_quad(pack_quad(src), xy, h, w)
        want = torch.autograd.grad(plain, leaves, G)
        rel = [((a - b).norm() / b.norm()).item() for a, b in zip(got, want)]
        print(f"warp-check L{l} f32 out {tuple(out.shape)}: forward vs "
              f"grid_sample_batched max_abs_err={e_fwd!r} (bound {TAP_TOL}); "
              f"gradient relative L2 vs plain autograd: features {rel[0]!r}, "
              f"proj {rel[1]!r}, depth {rel[2]!r} (bound {WARP_REL_TOL})")
        if not e_fwd <= TAP_TOL:
            raise AssertionError(f"L{l} warp forward error {e_fwd}")
        if not all(r <= WARP_REL_TOL for r in rel):
            raise AssertionError(f"L{l} warp gradient error {rel}")
        del out, got, xy, plain, want
    torch.cuda.synchronize()
    expect_counts(read_counts(), WARP_PATH, "f32 warp check")


def warp_pass(views) -> torch.Tensor:
    """Forward and backward of the warp for each of ``views`` (as
    :func:`warp_views` yields them); returns whether every output and
    gradient is finite, as a tensor on the card."""
    from casmvsnet_pl_tpu_torch.ops import pack_quad, warp_src_quad_batched
    flags = []
    for (l, C, D, h, w), leaves, G in views:
        src, P, d = leaves
        out = warp_src_quad_batched(pack_quad(src), P, d, h, w)
        grads = torch.autograd.grad(out, leaves, G)
        flags += [torch.isfinite(t).all() for t in (out, *grads)]
    return torch.stack(flags).all()


def warp_main_path(views, card) -> dict:
    """Phase 21, the warp's main path: bf16 forward and backward of both
    source views at each level, every output and gradient finite, the
    launches exactly WARP_PATH; returns the launches."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    finite = bool(warp_pass(views))
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"warp bf16 main path, B=2, both source views at 3 levels, forward "
          f"+ backward: {(time.perf_counter() - t0) * 1e3!r} ms wall, all "
          f"finite {finite}; launches {counts} [{card}]")
    expect_counts(counts, WARP_PATH, "bf16 warp")
    if not finite:
        raise AssertionError("non-finite warp output or gradient")
    return counts


def tap_reduce_work(N, C, itemsize, backward=False):
    """(bytes, float32 operations) of #7, or of #8 with ``backward``, for N
    samples: #7 reads the rows (4C values) and the f32 weights (16 B) once
    and writes the f32 output (4C B) once, 8C operations; #8 reads the
    rows, the weights and the f32 gradient and writes d rows and d w once,
    12C operations (d rows 4C, d w 8C)."""
    if not backward:
        return N * (4 * C * itemsize + 16 + 4 * C), N * 8 * C
    return N * (8 * C * itemsize + 4 * C + 32), N * 12 * C


def time_tap_reduce(inputs2, card) -> tuple[dict, float]:
    """Phase 22: #7 and #8 against their plain versions per level on one
    source view's bf16 rows (B=2), and #7's library call, a batched
    ``torch.matmul`` on the rows upcast to f32 outside the timed region.
    Returns the sums as :func:`time_kernels` does, and the library call's
    time summed over the levels."""
    from casmvsnet_pl_tpu_torch import kernels as k
    from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr
    g = torch.Generator(device=DEVICE).manual_seed(18)
    sums, library_ms = {}, 0.0
    for (l, C, D, h, w), rows, ws in tap_level_rows(inputs2, 19):
        rb = rows.to(torch.bfloat16)
        del rows
        N = rb.shape[0]
        go = torch.randn((N, C), generator=g, device=DEVICE)
        label = f"L{l} bf16 rows {tuple(rb.shape)}"
        time_level(sums, "tap_reduce_cuda", label,
                   lambda: k.tap_reduce_cuda(rb, ws),
                   lambda: tr.plain_tap_reduce(rb, ws), (50, 5),
                   tap_reduce_work(N, C, 2), card)
        time_level(sums, "tap_reduce_bwd_cuda", label,
                   lambda: k.tap_reduce_bwd_cuda(rb, ws, go),
                   lambda: tr.plain_tap_reduce_bwd(rb, ws, go), (50, 5),
                   tap_reduce_work(N, C, 2, backward=True), card)
        rf, wv = rb.float().view(N, 4, C), ws.view(N, 1, 4)
        ms = cuda_ms(lambda: torch.matmul(wv, rf), 20)
        err = (torch.matmul(wv, rf).view(N, C)
               - k.tap_reduce_cuda(rb, ws)).abs().max().item()
        print(f"timing library torch.matmul (N,1,4) x (N,4,C) f32 {label}: "
              f"{ms!r} ms, max_abs_err vs #7 {err!r} [{card}]")
        library_ms += ms
        del rb, ws, go, rf, wv
    return ({name: (k_ms, p_ms, *bound(nbytes, flops))
             for name, (k_ms, p_ms, nbytes, flops) in sums.items()},
            library_ms)


# --- the probes: TPU kernels #9-#13 -----------------------------------------

def probes_path(card) -> tuple[list, dict]:
    """Phases 23-26: each probe's main path on the card; returns the timed
    results and the launches counted over the four phases, in which every
    probe kernel launches."""
    from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = gather.main(DEVICE, card, IMG_WH)               # 23: #13
    data = epi3.inputs(DEVICE)
    results += epi3.run_copy(data, card)                      #     #11
    results += epi2.main(DEVICE, card)                        # 24: #9
    results += epi3.run_var(data, card)                       # 25: #10
    del data
    results += epi5.main(DEVICE, card)                        # 26: #12
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"probes path (phases 23-26): {time.perf_counter() - t0!r} s wall; "
          f"launches {counts} [{card}]")
    never = [n for n in PROBE_KERNELS if counts[n] < 1]
    if never:
        raise AssertionError(f"probe kernels never launched: {never}")
    return results, counts


def probe_summary(results) -> dict:
    """By wrapper name: the fastest configuration of each probe kernel, its
    results summed over the shapes it covers (k ms, plain ms, bound ms,
    bound by, max f32 error over every configuration, library ms, what the
    times cover)."""
    out = {}
    for name in PROBE_KERNELS:
        mine = [r for r in results if r.kernel == name]
        groups = {}
        for r in mine:
            groups.setdefault(r.group, []).append(r)
        group, rs = min(groups.items(),
                        key=lambda kv: sum(r.ms for r in kv[1]))
        libs = [r.library_ms for r in rs]
        out[name] = (sum(r.ms for r in rs), sum(r.plain_ms for r in rs),
                     *bound(sum(r.nbytes for r in rs),
                            sum(r.flops for r in rs)),
                     max(r.max_abs_err for r in mine),
                     None if None in libs else sum(libs),
                     f"{group}, the fastest of {sorted(groups)}; "
                     + " + ".join(r.label for r in rs))
    return out


HOST_CALLS = ("lane_gather_cuda", "index_select (lane gather's shape)",
              "row_gather_ldg_cuda", "index_select (row gather's shape)",
              "cost_volume_cuda", "t.new_empty (8, 128)",
              "cost_volume_bwd_cuda", "t.new_zeros (1, 3, 16, 16, 8)")


def host_costs(card) -> None:
    """Phase 27: host_us of HOST_CALLS, in turns; printed on one line."""
    from casmvsnet_pl_tpu_torch.probes import host
    calls = host.wrapper_calls(DEVICE)
    times = host.measure({n: calls[n] for n in HOST_CALLS})
    print("host_us, to enqueue one call: " + ", ".join(
        f"{n} {us!r} us" for n, us in times.items()) + f" [{card}]")


def kernel_line(name, source, replaces, launches_by_path, main_path,
                max_err, times, timed, library_ms=None) -> dict:
    """One entry of the kernels' JSON line; ``launches`` is the count of
    the ``main_path`` run."""
    k_ms, p_ms, b_ms, by = times
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_by_path[main_path],
            "launches_by_path": launches_by_path, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, "timed": timed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path",
              file=sys.stderr)
        return 1
    from casmvsnet_pl_tpu_torch.entry import entry, train_entry
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_bwd_cuda as kbwd
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda as kernel
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume as plain
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume_bwd as pbwd
    from casmvsnet_pl_tpu_torch.ops import plain_quad_cost_volume

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = toolchain()
    build_kernel(kernel)
    inputs = level_inputs()
    inputs2 = level_inputs(batch=2)
    errs = {"cost_volume_cuda": check_kernel(kernel, plain, inputs)}
    paths = {"inference": check_forward(entry, plain)}
    time_forward(entry, card)
    errs["cost_volume_bwd_cuda"] = check_bwd(kbwd, pbwd, inputs2)
    check_train_step(train_entry, plain, DEFAULT_STEP)
    trainer, state, batch, paths["train"] = train_main_path(
        train_entry, card, TRAIN_STEPS, DEFAULT_STEP)
    time_train(trainer, state, batch, card)
    del trainer, state, batch
    torch.cuda.empty_cache()

    errs.update(check_epilogues(inputs))
    errs.update(check_epilogues_bwd(inputs2))
    paths["quad_inference"] = check_quad_forward(entry)
    check_train_step(train_entry, plain_quad_cost_volume, QUAD_STEP,
                     sampling="quad")
    trainer, state, batch, paths["quad_train"] = train_main_path(
        train_entry, card, QUAD_TRAIN_STEPS, QUAD_STEP, sampling="quad")
    time_train(trainer, state, batch, card, label=" sampling=quad")
    del trainer, state, batch
    torch.cuda.empty_cache()
    g8 = {"sampling": "quad", "num_groups": 8}
    paths["quad_g8_inference"] = forward_main_path(
        entry, G8_FWD, " sampling=quad num_groups=8", **g8)
    *_, paths["quad_g8_train"] = train_main_path(
        train_entry, card, G8_TRAIN_STEPS, G8_STEP, **g8)
    torch.cuda.empty_cache()
    time_forward(entry, card, label=" sampling=quad", sampling="quad")
    kernel_times = time_kernels(inputs, inputs2, card)
    profile_paths(entry, train_entry, card)

    errs.update(check_tap_reduce(inputs2))
    check_warp(inputs2)
    views = list(warp_views(inputs2, torch.bfloat16, 17))
    paths["warp"] = warp_main_path(views, card)
    tap_times, tap_library_ms = time_tap_reduce(inputs2, card)
    kernel_times.update(tap_times)
    profile(lambda: warp_pass(views), " warp bf16 B=2 forward + backward, "
            "2 source views x 3 levels", card)
    del views
    torch.cuda.empty_cache()
    probe_results, paths["probes"] = probes_path(card)
    host_costs(card)

    # "launches" is the count of the kernel's main path (the default path's
    # training run for K1 and K2, the quad configuration's for #3-#6, the
    # warp's for #7/#8, the probes' for #9-#13); "launches_by_path" gives
    # every path's own run, and "timed" says what ms, plain_ms and bound_ms
    # cover. No single PyTorch call computes K1, K2, #3-#6, #9, #10 or #12,
    # so their library_ms is null; #7's is a batched torch.matmul, #11's
    # rows[..., :C].contiguous(), #13's index_select; #8 has none.
    def by_path(name, keys):
        return {p: paths[p].get(name, 0) for p in keys}

    default_paths = ("inference", "train", "quad_inference", "quad_train")
    g8_paths = ("quad_g8_inference", "quad_g8_train")
    csrc = "casmvsnet_pl_tpu_torch/csrc/"
    pe = "casmvsnet_pl_tpu/kernels/patch_epilogue.py:"
    kce = "scripts/kernel_cost_epilogue.py:"
    lines = []
    for name, source, replaces, keys, timed in (
            ("cost_volume", "cost_volume.cu", pe + "134", default_paths,
             "bf16 variance B=1"),
            ("cost_volume_bwd", "cost_volume_bwd.cu", pe + "172",
             default_paths, "bf16 variance B=2"),
            ("variance_epilogue", "cost_epilogue.cu", kce + "197",
             default_paths, "bf16 variance B=1"),
            ("variance_epilogue_bwd", "cost_epilogue_bwd.cu", kce + "224",
             default_paths, "bf16 variance B=2"),
            ("groupwise_epilogue", "cost_epilogue.cu", kce + "377", g8_paths,
             "bf16 G=8 B=1"),
            ("groupwise_epilogue_bwd", "cost_epilogue_bwd.cu", kce + "404",
             g8_paths, "bf16 G=8 B=2")):
        cname = name + "_cuda"
        main_path = ("quad_g8_train" if "groupwise" in name else "quad_train"
                     if "epilogue" in name else "train")
        lines.append(kernel_line(
            name, csrc + source, replaces, by_path(cname, keys), main_path,
            errs[cname], kernel_times[cname],
            timed + ", sum over the 3 level shapes"))
    ktr = "scripts/kernel_tap_reduce.py:"
    for name, line, library_ms in (("tap_reduce", "86", tap_library_ms),
                                   ("tap_reduce_bwd", "121", None)):
        cname = name + "_cuda"
        lines.append(kernel_line(
            name, csrc + "tap_reduce.cu", ktr + line,
            by_path(cname, default_paths + g8_paths + ("warp",)), "warp",
            errs[cname], kernel_times[cname],
            "bf16 rows of one source view B=2, sum over the 3 level shapes",
            library_ms))
    all_paths = default_paths + g8_paths + ("warp", "probes")
    summary = probe_summary(probe_results)
    for name, source, line in (
            ("lane_prefix_copy", "probe_copy_gather.cu", "probe_epi3.py:88"),
            ("row_gather_ldg", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("row_gather_cp_async", "probe_copy_gather.cu",
             "probe_gather.py:18"),
            ("row_gather_bulk", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("lane_gather", "probe_copy_gather.cu", "probe_gather.py:18"),
            ("variance_dblk", "probe_epilogue.cu", "probe_epi2.py:69"),
            ("variance_v3", "probe_epilogue.cu", "probe_epi3.py:62"),
            ("patch_epilogue_t", "patch_epilogue_t.cu", "probe_epi5.py:101")):
        k_ms, p_ms, b_ms, by, err, lib, timed = summary[name + "_cuda"]
        lines.append(kernel_line(
            name, csrc + source, "scripts/" + line,
            by_path(name + "_cuda", all_paths), "probes", err,
            (k_ms, p_ms, b_ms, by), timed, lib))
    for entry_ in lines:
        if entry_["launches"] < 1:
            raise AssertionError(f"{entry_['name']} never launched on its "
                                 "main path")
    print(json.dumps({"kernels": lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
