"""K1 (``csrc/cost_volume.cu``) on the card: its time per level beside its
bound, at the shapes of the main path and of the eval configuration,
optionally against the K1 of another tree in the same process.

Cases (bf16 features, the plane scene's projections and depth windows as
the cascade builds them, ``common.plane_levels``):

- ``fwd``: variance, B=1, 640x512x3 (the inference forward);
- ``step``: variance, B=2 (the train step's forward);
- ``g8``: groupwise G=8, B=1;
- ``eval``: variance, B=1, 1152x864x5 (the eval configuration).

Every build is checked first against ``ops/plane_sweep.py::
plain_cost_volume`` at the ``fwd`` and ``eval`` shapes: float32 equal to
the bit (variance, G = 2, 4, 8), bf16 within one bf16 ulp of the plain
float32 result. Then the builds are timed in turns at each level (CUDA
events; the order reversed in the second turn). The kernel sums a group's
channels in the order of torch's CUDA reduction, so the run first prints
which order torch's ``sum`` takes on this card.

    python -m casmvsnet_pl_tpu_torch.probes.k1 [--parent DIR]
        [--cases fwd,step,g8,eval] [--out FILE]

``--parent`` builds ``casmvsnet_pl_tpu_torch/csrc/cost_volume.cu`` of
another tree (a ``git archive`` of an earlier commit) into an object with
its C entries renamed, linked into a library of its own in ``_build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels.cost_volume import (BUILD_DIR, NVCC_FLAGS, CostVolumeKernel,
                                   cost_volume_cuda, find_nvcc)
from ..ops.plane_sweep import plain_cost_volume
from . import common

CASES = {   # name: (img_wh, views, batch, groups)
    "fwd": ((640, 512), 3, 1, 1),
    "step": ((640, 512), 3, 2, 1),
    "g8": ((640, 512), 3, 1, 8),
    "eval": ((1152, 864), 5, 1, 1),
    "bmvs_step": ((768, 576), 3, 2, 1),     # BlendedMVS's train step
}


class _Library:
    """The parent tree's K1 in a library of its own, as ``_Kernel`` uses
    it: its entries carry the suffix ``_parent``."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        err = lib.cost_volume_error_string_parent
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self._err = err

    def build(self) -> ctypes.CDLL:
        return self.lib

    def check(self, err: int, name: str) -> None:
        raise RuntimeError(f"{name} launch failed: "
                           + self._err(err).decode())


def build_parent(tree: Path) -> tuple[CostVolumeKernel, str]:
    """Compile ``tree``'s K1 source with its C entries renamed
    ``<entry>_parent`` and link it into a library of its own; returns its
    kernel and the ptxas log."""
    src = (tree / "casmvsnet_pl_tpu_torch" / "csrc" / "cost_volume.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(src.parent.glob("*.cu*")):
        h.update(p.read_bytes())
    out = BUILD_DIR / f"k1_parent_{h.hexdigest()[:12]}"
    out.mkdir(parents=True, exist_ok=True)
    tu = out / "parent.cu"
    tu.write_text("".join(f"#define {e} {e}_parent\n" for e in (
        "cost_volume_fwd", "cost_volume_error_string"))
        + f'#include "{src.resolve()}"\n')
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-c", "-o",
                           str(out / "parent.o"), str(tu)],
                          capture_output=True, text=True, check=True)
    subprocess.run([find_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                    str(out / "parent.so"), str(out / "parent.o")],
                   check=True)
    lib = _Library(ctypes.CDLL(str(out / "parent.so")))
    return (CostVolumeKernel(lib, "parent", "cost_volume_fwd_parent"),
            proc.stdout + proc.stderr)


def registers(log: str) -> dict:
    """'T C G' -> (registers, spill store bytes) from ptxas -v output; the
    groupwise correlation with one group (kind ``Lb0E`` at G = 1) as
    'T C G=1 groupwise'."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"cost_volume_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E"
                      r"(?:Lb([01])E)?", line)
        if "Compiling entry function" in line:
            cur = (("f32" if m.group(1) == "f" else "bf16") +
                   f" C={m.group(2)} G={m.group(3)}" +
                   (" groupwise" if m.group(3) == "1" and m.group(4) == "0"
                    else "")) if m else None
        elif cur and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            out[cur] = [None, spill]
        elif cur and "Used" in line and cur in out:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line)
                              .group(1))
            cur = None
    return out


def reduce_order(device) -> dict:
    """Which order torch's sum over a last dim of n (n = 2..16) adds in
    on this device: mismatches against halving, doubling and sequential
    orders written out with elementwise adds, over random inputs of wide
    range."""
    g = torch.Generator(device=device).manual_seed(0)
    out = {}
    for n in (4, 8, 16):
        x = torch.randn((1 << 16, n), generator=g, device=device) * \
            torch.exp2(torch.randint(-20, 20, (1 << 16, n), generator=g,
                                     device=device).float())
        got = x.sum(-1)
        p = list(x.unbind(-1))
        half, off = list(p), n // 2
        while off:
            half = [half[i] + half[i + off] for i in range(off)]
            off //= 2
        dbl, off = list(p), 1
        while off < n:
            dbl = [dbl[i] + dbl[i + off] if i % (2 * off) == 0 else dbl[i]
                   for i in range(n)]
            off *= 2
        seq = p[0]
        for t in p[1:]:
            seq = seq + t
        out[n] = {k: int((got != v).sum()) for k, v in
                  (("halving", half[0]), ("doubling", dbl[0]),
                   ("sequential", seq))}
    return out


def case_inputs(device, case: str):
    """(levels, inputs, groups, batch, views) of a case."""
    img_wh, views, batch, groups = CASES[case]
    return (common.default_levels(img_wh),
            common.plane_levels(device, batch, img_wh, views), groups, batch,
            views)


def check(kernels: dict, device, cases=("fwd", "eval")) -> dict:
    """Every build against the plain version at the shapes of ``cases``
    (fwd: variance and G = 2, 4, 8; other cases their own G); returns by
    name the max float32 error (raises on a miss)."""
    g = torch.Generator(device=device).manual_seed(0)
    worst = {n: 0.0 for n in kernels}
    for case in cases:
        lv, inputs, G, B, V = case_inputs(device, case)
        for l, C, D, h, w in lv:
            proj, dv = inputs[l]
            feats = torch.rand((B, V, h, w, C), generator=g, device=device)
            fb = feats.to(torch.bfloat16)
            for groups in (1, 2, 4, 8) if case == "fwd" else (G,):
                want = plain_cost_volume(feats, proj, dv, groups)
                want_b = plain_cost_volume(fb.float(), proj, dv, groups)
                for name, k in kernels.items():
                    got = k(feats, proj, dv, groups)
                    err = (got - want).abs().max().item()
                    worst[name] = max(worst[name], err)
                    ulps = common.check_ulp(f"{name} {case} L{l} G={groups}",
                                            k(fb, proj, dv, groups), want_b)
                    # the parent tree summed a group's channels in order:
                    # within 1e-5 of torch's order
                    exact = name != "parent" or groups == 1
                    if not (torch.equal(got, want) if exact else err <= 1e-5):
                        raise AssertionError(
                            f"{name} {case} L{l} G={groups}: f32 differs "
                            f"from the plain version by {err!r}")
                    print(f"check {name} {case} L{l} G={groups}: f32 err "
                          f"{err!r}, bf16 max_ulps={ulps!r}")
                del want, want_b
    return worst


def time_cases(kernels: dict, cases, device, card: str, iters: int = 50):
    """Per case and level, each build's ms (two turns, the order reversed
    in the second), summed over the levels; printed beside the bound."""
    g = torch.Generator(device=device).manual_seed(1)
    table = {}
    for case in cases:
        lv, inputs, groups, B, V = case_inputs(device, case)
        sums = {n: [0.0, []] for n in kernels}
        nbytes = flops = 0.0
        for l, C, D, h, w in lv:
            proj, dv = inputs[l]
            fb = torch.rand((B, V, h, w, C), generator=g,
                            device=device).to(torch.bfloat16)
            names = list(kernels)
            ms = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    k = kernels[n]
                    ms[n].append(common.cuda_ms(
                        lambda: k(fb, proj, dv, groups), iters))
            wb, wf = common.cv_work(B, V, D, h, w, C, groups, 2)
            nbytes += wb
            flops += wf
            b_ms, _ = common.bound(wb, wf)
            for n in names:
                t = sum(ms[n]) / 2
                sums[n][0] += t
                sums[n][1].append(t)
                print(f"k1 {case} L{l} (B={B}, V={V}, C={C}, D={D}, {h}x{w}, "
                      f"G={groups}) {n}: {t!r} ms ({ms[n][0]!r}, "
                      f"{ms[n][1]!r}); bound {b_ms!r} ms, "
                      f"{100 * b_ms / t!r} % [{card}]")
            del fb
        b_ms, by = common.bound(nbytes, flops)
        for n, (t, per) in sums.items():
            print(f"k1 {case} sum {n}: {t!r} ms ({' / '.join(map(repr, per))})"
                  f"; bound {b_ms!r} ms by {by}, {100 * b_ms / t!r} % "
                  f"[{card}]")
            table.setdefault(case, {})[n] = {"ms": t, "levels": per,
                                             "bound_ms": b_ms}
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--cases", default="fwd,step,g8,eval")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    device = "cuda"
    if not torch.cuda.is_available():
        print("k1: no CUDA device", file=sys.stderr)
        return 1
    card = common.card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} [{card}]")
    print("torch sum order (mismatches):", reduce_order(device))
    cost_volume_cuda.build()
    kernels = {"tree": cost_volume_cuda}
    regs = {"tree": registers(cost_volume_cuda.build_log)}
    if args.parent:
        kernels["parent"], log = build_parent(args.parent)
        regs["parent"] = registers(log)
    for name, r in regs.items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v[0]} ({v[1]} B spilled)" for k, v in sorted(r.items())))
    check(kernels, device)
    table = time_cases(kernels, [c for c in args.cases.split(",") if c],
                       device, card)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "registers": regs,
                                        "times": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
