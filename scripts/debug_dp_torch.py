"""Debug: diff one training step on 1 rank against the same step on N ranks.

The port's counterpart of ``scripts/debug_dp.py``: one SGD step (lr 1e-2,
no momentum, no weight decay) of ``entry.data_parallel_step`` on a global
batch of ``chip_smoke.DP_BATCH`` distinct plane scenes, once in this
process and once on N ranks (``parallel.spawn``), each rank taking its
rows of the same global batch; prints both losses, the gradient leaves
that differ most, the BatchNorm statistics that differ, the step's own
reordering noise (one process with the rows permuted), whether the ranks'
gradients are equal to the bit and each rank's kernel launches. The
differences are ``chip_smoke.leaf_differences``; ``multicard_smoke.py``
M1 runs this script and holds what it returns to ``chip_smoke``'s bounds.

    python scripts/debug_dp_torch.py                   # 4 ranks, 4 cards, NCCL
    python scripts/debug_dp_torch.py --cpu --ranks 2 --img_wh 64 64

On the card the N ranks take one card each over NCCL, and this process's
step runs on card 0 (cuDNN's deterministic algorithms); with fewer than N
cards visible it exits 1. ``--cpu`` runs N processes over gloo.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402
from casmvsnet_pl_tpu_torch.entry import data_parallel_step  # noqa: E402
from casmvsnet_pl_tpu_torch.parallel import spawn  # noqa: E402

TIMEOUT_S = 900
TOP = 12                # gradient leaves printed


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--img_wh", type=int, nargs=2, default=(640, 512))
    p.add_argument("--n_depths", type=int, nargs=3, default=(8, 32, 48))
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="N processes on the CPU over gloo")
    return p


def main(argv=None) -> dict:
    """Run and print the comparison; return the step's ``spec``, this
    process's ``reference`` (``chip_smoke.dp_reference``), the ``ranks``'
    saved steps, ``spawned`` (s with the ranks' start), the per-leaf
    differences of rank 0 (``grads``, ``stats``) and ``same`` (the ranks'
    gradients equal to the bit)."""
    args = parser().parse_args(argv)
    if not args.cpu and torch.cuda.device_count() < args.ranks:
        print(f"debug_dp_torch.py: {args.ranks} ranks need {args.ranks} "
              f"cards over NCCL, {torch.cuda.device_count()} visible (--cpu "
              f"runs them on the CPU over gloo)", file=sys.stderr)
        raise SystemExit(1)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="debug_dp_") as tmp:
        spec = dict(batch=chip_smoke.DP_BATCH, img_wh=tuple(args.img_wh),
                    n_depths=tuple(args.n_depths), lr=1e-2,
                    dtype=getattr(torch, args.dtype),
                    deterministic=not args.cpu,
                    out=os.path.join(tmp, "step"))
        reference = chip_smoke.dp_reference(spec, device)
        t0 = time.perf_counter()
        spawn(data_parallel_step, args.ranks, (spec,), cpu=args.cpu,
              timeout_s=TIMEOUT_S, pg_timeout_s=TIMEOUT_S)
        spawned = time.perf_counter() - t0
        ranks = [torch.load(f"{spec['out']}.{r}")
                 for r in range(args.ranks)]
    one, noise, _ = reference
    backend = "gloo, CPU" if args.cpu else "NCCL, one card a rank"
    print(f"n_ranks=1 loss={one['loss']:.8f}")
    print(f"n_ranks={args.ranks} loss={ranks[0]['loss']:.8f} ({backend}; "
          f"global batch {spec['batch']} at {args.img_wh[0]}x"
          f"{args.img_wh[1]}x3, {args.dtype})")
    grads, stats = chip_smoke.leaf_differences(ranks[0], one)
    for name in sorted(grads, key=grads.get, reverse=True)[:TOP]:
        print(f"rel_l2={grads[name]:.3e} "
              f"gradnorm={one['grads'][name].double().norm().item():.3e} "
              f"{name}")
    print("--- batch_stats diffs ---")
    for name, diff in stats.items():
        if diff > 1e-6:
            print(f"rel={diff:.3e} {name}")
    print("one process with the rows permuted (gradients, statistics, "
          f"loss): {noise!r}")
    same = all(torch.equal(ranks[0]["grads"][k], r["grads"][k])
               for r in ranks[1:] for k in one["grads"])
    print(f"ranks' gradients equal to the bit: {same}")
    for r, x in enumerate(ranks):
        print(f"rank {r} launches {x['launches']}")
    print(f"one process launches {one['launches']}")
    return {"spec": spec, "reference": reference, "ranks": ranks,
            "spawned": spawned, "grads": grads, "stats": stats,
            "same": same}


if __name__ == "__main__":
    main()
