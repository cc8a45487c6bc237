"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. require a CUDA device (there is no CPU path);
  2. print the toolchain: torch, CUDA, the card, nvidia-smi, nvcc, triton;
  3. build the cost-volume kernel from casmvsnet_pl_tpu_torch/csrc/;
  4. hold the kernel against its plain PyTorch version at the three cascade
     level shapes (B=1), in f32 (<= 1e-4 abs) and bf16 (<= 1 bf16 ulp of
     the plain f32 result), for variance and groupwise (G=8);
  5. run the inference forward through ``entry``: f32 with the kernel
     against f32 with the plain cost volume (< 0.05 mm on depth_0), and the
     bf16 main path, counting exactly one kernel launch per level;
  6. time bf16 forwards at B=1 and B=4 and the kernel against the plain
     version per level, with CUDA events;
  7. (below, after phase 11) print the kernels' JSON line (launches per
     main path; what each time covers), then {"ok": true, "device": ...}
     last;
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
 11. time the bf16 train step (stages, step, samples/s, peak memory) and
     K2 against the plain backward per level, with CUDA events.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import torch

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


def levels():
    """(level, C, D, h, w) of the default config, coarse to fine."""
    W, H = IMG_WH
    return [(l, 8 << l, d, H >> l, W >> l)
            for l, d in ((2, 48), (1, 32), (0, 8))]


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
    from casmvsnet_pl_tpu_torch.data import PlaneScene
    from casmvsnet_pl_tpu_torch.entry import DEPTH_INTERVAL, DEPTH_MIN
    from casmvsnet_pl_tpu_torch.ops import (get_depth_values,
                                            initial_depth_values,
                                            resize_bilinear)
    scene = PlaneScene(img_wh=IMG_WH, n_views=3, z0=460.0, baseline=12.0,
                       focal=600.0, slope_x=0.2)
    _, proj, depths = scene.model_inputs()
    proj = torch.from_numpy(proj).to(DEVICE)
    out = {}
    for l, C, D, h, w in levels():
        interval = DEPTH_INTERVAL * 2 ** l
        if l == 2:
            dv = initial_depth_values(DEPTH_MIN, interval, D, 1, h, w,
                                      device=DEVICE)
        else:
            # recentre on the next-coarser depth, upsampled x2
            prev = torch.from_numpy(depths[f"level_{l + 1}"]).to(DEVICE)
            prev = resize_bilinear(prev[..., None], (h, w))[..., 0]
            dv = get_depth_values(prev, D, interval)
        out[l] = (proj[:, :, l].repeat(batch, 1, 1, 1).contiguous(),
                  dv.repeat(batch, 1, 1, 1).contiguous())
    return out


def bf16_ulp(x):
    """Spacing of bf16 numbers at x (bf16 holds 8 significant bits)."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, torch.full_like(ulp, 2.0 ** -133), ulp)


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


def check_forward(kernel, entry, plain) -> int:
    """f32 kernel vs plain forward, then the bf16 main path; returns the
    kernel launches counted over the main path's run."""
    fn, args = entry(DEVICE, torch.float32, img_wh=IMG_WH)
    with torch.no_grad():
        # sharpen the softmax over depth, so depth_0 follows the cost volume
        for l in range(3):
            getattr(args[0], f"cost_reg_{l}").prob.weight *= 30.0
    kernel.launches = 0
    d_k, c_k = fn(*args)
    torch.cuda.synchronize()
    if kernel.launches != 3:
        raise AssertionError(f"f32 forward launched {kernel.launches}, not 3")
    d_p, c_p = fn(*args, cost_volume=plain)
    torch.cuda.synchronize()
    if kernel.launches != 3:
        raise AssertionError("the plain forward launched the kernel")
    dd = (d_k - d_p).abs().max().item()
    dc = (c_k - c_p).abs().max().item()
    print(f"forward f32 kernel vs plain: max|d depth_0|={dd!r} mm "
          f"(bound {DEPTH_TOL_MM}), max|d confidence_2|={dc!r}, "
          f"depth_0 range [{d_k.min().item()!r}, {d_k.max().item()!r}]")
    if not dd < DEPTH_TOL_MM:
        raise AssertionError(f"f32 depth_0 kernel vs plain {dd} mm")
    del fn, args

    fn, args = entry(DEVICE, torch.bfloat16, img_wh=IMG_WH)
    kernel.launches = 0
    depth, conf = fn(*args)
    torch.cuda.synchronize()
    launches = kernel.launches
    print(f"forward bf16 main path: kernel launches={launches}, "
          f"depth_0 {tuple(depth.shape)} range [{depth.min().item()!r}, "
          f"{depth.max().item()!r}], confidence_2 {tuple(conf.shape)} range "
          f"[{conf.min().item()!r}, {conf.max().item()!r}]")
    if launches != 3:
        raise AssertionError(f"bf16 forward launched {launches}, not 3")
    W, H = IMG_WH
    if tuple(depth.shape) != (1, H, W) or tuple(conf.shape) != (1, H // 4,
                                                                W // 4):
        raise AssertionError("wrong output shapes")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise AssertionError("non-finite outputs")
    if not (conf.min() >= 0 and conf.max() <= 1):
        raise AssertionError("confidence outside [0, 1]")
    return launches


def cuda_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_all(kernel, entry, plain, inputs, card) -> tuple[float, float]:
    """Forward times at B=1 and 4, then kernel and plain per level (bf16,
    variance, B=1, in turns plain/kernel/kernel/plain); returns the sums of
    the per-level kernel and plain times."""
    for batch in (1, 4):
        fn, args = entry(DEVICE, torch.bfloat16, batch=batch, img_wh=IMG_WH)
        fn(*args)
        ms = cuda_ms(lambda: fn(*args), 10)
        print(f"timing forward bf16 B={batch} {IMG_WH[0]}x{IMG_WH[1]}x3: "
              f"{ms!r} ms/forward, "
              f"{batch * 1000.0 / ms!r} maps/s [{card}]")
        del fn, args
    g = torch.Generator(device=DEVICE).manual_seed(1)
    k_sum = p_sum = 0.0
    for l, C, D, h, w in levels():
        proj, dv = inputs[l]
        fb = torch.rand((1, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        p1 = cuda_ms(lambda: plain(fb, proj, dv), 5)
        k1 = cuda_ms(lambda: kernel(fb, proj, dv), 50)
        k2 = cuda_ms(lambda: kernel(fb, proj, dv), 50)
        p2 = cuda_ms(lambda: plain(fb, proj, dv), 5)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        out_mb = D * h * w * C * 2 / 1e6
        print(f"timing cost volume L{l} bf16 (1,{D},{h},{w},{C}): kernel "
              f"{k_ms!r} ms ({k1!r}, {k2!r}), plain {p_ms!r} ms ({p1!r}, "
              f"{p2!r}), output write {out_mb!r} MB -> "
              f"{out_mb / 1e3 / k_ms!r} TB/s [{card}]")
        k_sum += k_ms
        p_sum += p_ms
    return k_sum, p_sum


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


def check_train_step(kernels, train_entry, plain) -> None:
    """f32 SGD step with the kernels against one with the plain cost volume,
    from the same state and batch."""
    kernel, kernel_bwd = kernels
    runs = {}
    # cuDNN's default conv backward sums in a run-dependent order, which
    # moves some leaves by ~4e-3 between two identical plain steps; its
    # deterministic algorithms leave the cost volume as the only difference.
    torch.backends.cudnn.deterministic = True
    for name, cv in (("kernel", None), ("plain", plain)):
        kw = {} if cv is None else {"cost_volume": cv}
        trainer, state, batch = train_entry(
            DEVICE, torch.float32, img_wh=IMG_WH, optimizer="sgd", lr=1e-2,
            **kw)
        kernel.launches = kernel_bwd.launches = 0
        state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        runs[name] = (float(logs["train/loss"]),
                      {n: p.grad.double() for n, p in
                       state.model.named_parameters()},
                      (kernel.launches, kernel_bwd.launches))
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
    print(f"train step f32 kernel vs plain: loss {lk!r} vs {lp!r}, "
          f"worst gradient leaf relative L2 {worst!r} (bound "
          f"{GRAD_REL_TOL}), launches K1/K2 kernel step {nk}, plain step "
          f"{npl}")
    if nk != (3, 3) or npl != (0, 0):
        raise AssertionError(f"launches {nk} / {npl}, not (3, 3) / (0, 0)")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"loss {lk} vs {lp}")
    if not worst <= GRAD_REL_TOL:
        raise AssertionError(f"gradient leaf relative error {worst}")


def train_main_path(kernels, train_entry, card):
    """bf16 Adam at full width on one batch; returns (trainer, state,
    batch, launches of K1 and K2 over the run)."""
    kernel, kernel_bwd = kernels
    trainer, state, batch = train_entry(DEVICE, img_wh=IMG_WH)
    kernel.launches = kernel_bwd.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, logs = trainer.train_step(state, batch)
        losses.append(float(logs["train/loss"]))
    torch.cuda.synchronize()
    launches = (kernel.launches, kernel_bwd.launches)
    W, H = IMG_WH
    print(f"train bf16 {W}x{H}x3 B=2 adam lr 1e-3, {TRAIN_STEPS} steps on "
          f"one batch: losses {losses!r}; launches K1/K2 {launches} "
          f"[{card}]")
    if launches != (3 * TRAIN_STEPS, 3 * TRAIN_STEPS):
        raise AssertionError(f"launches {launches}, not 3 per step each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    return trainer, state, batch, launches


def time_train(trainer, state, batch, card) -> None:
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
    print(f"timing train step bf16 B=2 {IMG_WH[0]}x{IMG_WH[1]}x3 adam: "
          f"{ms!r} ms/step, {2 * 1000.0 / ms!r} samples/s, peak memory "
          f"{peak!r} GiB; stages (mean of 5): forward+loss {fwd!r} ms, "
          f"backward {bwd!r} ms, optimizer {upd!r} ms [{card}]")


def time_bwd(kernel_bwd, plain_bwd, inputs2, card) -> tuple[float, float]:
    """K2 against the plain backward per level (bf16, variance, B=2, in
    turns plain/kernel/kernel/plain); returns the sums over the levels."""
    g = torch.Generator(device=DEVICE).manual_seed(3)
    k_sum = p_sum = 0.0
    for l, C, D, h, w in levels():
        proj, dv = inputs2[l]
        fb = torch.rand((2, 3, h, w, C), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        gb = torch.randn((2, D, h, w, C), generator=g,
                         device=DEVICE).to(torch.bfloat16)
        p1 = cuda_ms(lambda: plain_bwd(fb, proj, dv, gb), 3)
        k1 = cuda_ms(lambda: kernel_bwd(fb, proj, dv, gb), 20)
        k2 = cuda_ms(lambda: kernel_bwd(fb, proj, dv, gb), 20)
        p2 = cuda_ms(lambda: plain_bwd(fb, proj, dv, gb), 3)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        atomics = 2 * D * h * w * 2 * 4 * C
        print(f"timing cost volume bwd L{l} bf16 feats (2,3,{h},{w},{C}) "
              f"D={D}: kernel {k_ms!r} ms ({k1!r}, {k2!r}), plain {p_ms!r} "
              f"ms ({p1!r}, {p2!r}), {atomics / 1e9!r} G f32 atomics -> "
              f"{atomics / 1e6 / k_ms!r} G atomics/s [{card}]")
        k_sum += k_ms
        p_sum += p_ms
    return k_sum, p_sum


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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = toolchain()
    build_kernel(kernel)
    inputs = level_inputs()
    max_err = check_kernel(kernel, plain, inputs)
    launches = check_forward(kernel, entry, plain)
    k_ms, p_ms = time_all(kernel, entry, plain, inputs, card)
    inputs2 = level_inputs(batch=2)
    bwd_err = check_bwd(kbwd, pbwd, inputs2)
    check_train_step((kernel, kbwd), train_entry, plain)
    trainer, state, batch, (n_fwd, n_bwd) = train_main_path(
        (kernel, kbwd), train_entry, card)
    time_train(trainer, state, batch, card)
    del trainer, state, batch
    kb_ms, pb_ms = time_bwd(kbwd, pbwd, inputs2, card)
    print(f"inference main path: K1 launches {launches}; training main "
          f"path: K1 {n_fwd}, K2 {n_bwd}")
    # "launches" is the training main path's count; "launches_by_path"
    # gives each path's own run, and "timed" says what ms/plain_ms time.
    print(json.dumps({"kernels": [{
        "name": "cost_volume", "route": "cuda",
        "source": "casmvsnet_pl_tpu_torch/csrc/cost_volume.cu",
        "replaces": "casmvsnet_pl_tpu/kernels/patch_epilogue.py:134",
        "launches": n_fwd,
        "launches_by_path": {"inference": launches, "train": n_fwd},
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "timed": "bf16 variance B=1, sum over the 3 level shapes"}, {
        "name": "cost_volume_bwd", "route": "cuda",
        "source": "casmvsnet_pl_tpu_torch/csrc/cost_volume_bwd.cu",
        "replaces": "casmvsnet_pl_tpu/kernels/patch_epilogue.py:172",
        "launches": n_bwd, "launches_by_path": {"train": n_bwd},
        "max_abs_err": bwd_err, "ms": kb_ms, "plain_ms": pb_ms,
        "timed": "bf16 variance B=2, sum over the 3 level shapes"}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
