"""DTU quantitative evaluation CLI of the PyTorch port (Python port of the
MATLAB benchmark).

The counterpart of ``eval_dtu.py``, with its flags, printout and JSON,
reading and scoring through ``casmvsnet_pl_tpu_torch.fusion.read_ply`` and
``casmvsnet_pl_tpu_torch.evaluation`` (numpy and scipy KD-trees; no JAX).
For leaderboard-comparable numbers use the official MATLAB scripts (see
README.md in this directory).

Usage:
    python evaluations/dtu/eval_dtu_torch.py \
        --ply_dir results/dtu/points \
        --gt_dir  /data/DTU/SampleSet/MVS\\ Data/Points/stl \
        --mask_dir /data/DTU/SampleSet/MVS\\ Data/ObsMask \
        --scans 1 4 9 ...

GT file layout (official SampleSet): stl/stl{scan:03d}_total.ply,
ObsMask/ObsMask{scan}_10.mat, ObsMask/Plane{scan}.mat.
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

DEFAULT_TEST_SCANS = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34,
                      48, 49, 62, 75, 77, 110, 114, 118]


def read_ply_xyz(path):
    """Read xyz from binary PLY; falls back to an ASCII reader."""
    from casmvsnet_pl_tpu_torch.fusion import read_ply
    try:
        return read_ply(path)[0]
    except ValueError:
        # ASCII or different layout: minimal generic fallback
        import numpy as np
        with open(path, "rb") as f:
            header, n, props = [], 0, []
            for line in f:
                header.append(line.strip())
                if line.startswith(b"element vertex"):
                    n = int(line.split()[-1])
                elif line.startswith(b"property"):
                    props.append(line.split()[-1].decode())
                if line.strip() == b"end_header":
                    break
            if b"format ascii 1.0" not in b"\n".join(header):
                raise
            data = np.loadtxt(f, max_rows=n)
        ix = [props.index(c) for c in ("x", "y", "z")]
        return data[:, ix]


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--ply_dir", type=str, default="results/dtu/points")
    parser.add_argument("--gt_dir", type=str, required=True,
                        help="directory with stl{scan:03d}_total.ply")
    parser.add_argument("--mask_dir", type=str, default="",
                        help="directory with ObsMask{scan}_10.mat / "
                             "Plane{scan}.mat (optional)")
    parser.add_argument("--scans", nargs="+", type=int,
                        default=DEFAULT_TEST_SCANS)
    parser.add_argument("--dst", type=float, default=0.2)
    parser.add_argument("--max_dist", type=float, default=20.0)
    parser.add_argument("--out_json", type=str, default="dtu_eval.json")
    args = parser.parse_args(argv)

    from casmvsnet_pl_tpu_torch.evaluation import aggregate, evaluate_scan

    results = []
    for scan in args.scans:
        data = read_ply_xyz(os.path.join(args.ply_dir, f"scan{scan}.ply"))
        stl = read_ply_xyz(os.path.join(args.gt_dir,
                                        f"stl{scan:03d}_total.ply"))
        obs = plane = None
        if args.mask_dir:
            obs = os.path.join(args.mask_dir, f"ObsMask{scan}_10.mat")
            plane = os.path.join(args.mask_dir, f"Plane{scan}.mat")
            if not os.path.exists(obs):
                obs = None
            if not os.path.exists(plane):
                plane = None
        r = evaluate_scan(data, stl, scan, dst=args.dst,
                          max_dist=args.max_dist, obs_mask_file=obs,
                          plane_file=plane)
        print(f"scan{scan}: acc={r.mean_acc:.4f} comp={r.mean_comp:.4f} "
              f"overall={r.overall:.4f}")
        results.append(r)
    stats = aggregate(results)
    print(f"mean: acc={stats['mean_acc']:.4f} comp={stats['mean_comp']:.4f} "
          f"overall={stats['overall']:.4f}")
    with open(args.out_json, "w") as f:
        json.dump({"per_scan": [vars(r) for r in results],
                   "aggregate": stats}, f, indent=2)


if __name__ == "__main__":
    main()
