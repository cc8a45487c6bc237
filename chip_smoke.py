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
  7. print the kernels' JSON line, then {"ok": true, "device": ...} last.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
IMG_WH = (640, 512)
F32_TOL = 1e-4          # abs, features in [0, 1): coordinates reach ~640 px
DEPTH_TOL_MM = 0.05     # tests/test_torch_parity.py


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


def level_inputs():
    """Per level: (proj (1, 2, 3, 4), depth windows (1, D, h, w)), built
    the way the cascade builds them, on the plane scene."""
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
        out[l] = (proj[:, :, l].contiguous(), dv.contiguous())
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path",
              file=sys.stderr)
        return 1
    from casmvsnet_pl_tpu_torch.entry import entry
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda as kernel
    from casmvsnet_pl_tpu_torch.ops import plain_cost_volume as plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = toolchain()
    build_kernel(kernel)
    inputs = level_inputs()
    max_err = check_kernel(kernel, plain, inputs)
    launches = check_forward(kernel, entry, plain)
    k_ms, p_ms = time_all(kernel, entry, plain, inputs, card)
    print(json.dumps({"kernels": [{
        "name": "cost_volume", "route": "cuda",
        "source": "casmvsnet_pl_tpu_torch/csrc/cost_volume.cu",
        "replaces": "casmvsnet_pl_tpu/kernels/patch_epilogue.py:134",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
