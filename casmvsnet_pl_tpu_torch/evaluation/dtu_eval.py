"""Python reimplementation of the official DTU point-cloud benchmark.

The port's copy of ``casmvsnet_pl_tpu/evaluation/dtu_eval.py`` (numpy and
scipy). The official benchmark is MATLAB (BaseEvalMain_web.m,
ComputeStat_web.m, PointCompareMain.m, reducePts_haa.m, MaxDistCP.m);
submissions should still use it for published numbers, see
evaluations/dtu/README.md. This module reproduces its pipeline for smoke
checks and fast iteration:

  1. stochastic point thinning so no two points are closer than ``dst``
     (= 0.2 mm), mirroring reducePts_haa.m:1-35;
  2. bidirectional nearest-neighbor distances (accuracy: data->stl,
     completeness: stl->data) within the GT bounding box, mirroring
     MaxDistCP.m / PointCompareMain.m:20-27 (KD-tree instead of the MATLAB
     grid-chunked KNN -- identical distances, different engine);
  3. observability filtering: accuracy points must fall inside the scan's
     ObsMask voxel grid (dilated), completeness points must lie above the
     ground plane -- BaseEvalMain_web.m:52-66;
  4. aggregation with the 20 mm outlier cutoff -- ComputeStat_web.m:12.

ObsMask/Plane .mat files ship with the official "SampleSet" and are loaded
with scipy.io when provided; without them the unfiltered chamfer metrics are
returned (fine for regression tests, not comparable to the leaderboard).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


def reduce_points(pts: np.ndarray, dst: float = 0.2,
                  seed: int = 0) -> np.ndarray:
    """Stochastic thinning: keep a random subset such that no two kept points
    are within ``dst`` of each other (reducePts_haa.m semantics: random
    visiting order, a point is kept iff no already-kept point is within dst).
    """
    n = pts.shape[0]
    order = np.random.RandomState(seed).permutation(n)
    tree = cKDTree(pts)
    # For each point, neighbors within dst. Visit in random order; keep a
    # point iff none of its earlier-visited neighbors was kept.
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    keep = np.zeros(n, bool)
    pairs = tree.query_pairs(dst, output_type="ndarray")  # (M, 2) i<j unique
    # adjacency in visiting order
    import collections
    adj = collections.defaultdict(list)
    for i, j in pairs:
        if rank[i] < rank[j]:
            adj[j].append(i)
        else:
            adj[i].append(j)
    for idx in order:
        earlier = adj.get(idx)
        if earlier is None or not any(keep[e] for e in earlier):
            keep[idx] = True
    return pts[keep]


@dataclasses.dataclass
class DTUScanResult:
    scan: int
    mean_acc: float       # mean data->stl distance (mm), outliers dropped
    mean_comp: float      # mean stl->data distance (mm), outliers dropped
    median_acc: float
    median_comp: float
    n_data: int
    n_stl: int

    @property
    def overall(self) -> float:
        return 0.5 * (self.mean_acc + self.mean_comp)


def _load_obs_mask(obs_mask_file: str):
    from scipy.io import loadmat
    m = loadmat(obs_mask_file)
    # BaseEvalMain_web.m:52: ObsMask, BB, Res
    return m["ObsMask"], m["BB"], float(np.ravel(m["Res"])[0])


def _load_ground_plane(plane_file: str) -> np.ndarray:
    from scipy.io import loadmat
    return np.ravel(loadmat(plane_file)["P"])[:4]


def evaluate_scan(data_pts: np.ndarray, stl_pts: np.ndarray, scan: int = 0,
                  dst: float = 0.2, max_dist: float = 20.0,
                  obs_mask_file: str | None = None,
                  plane_file: str | None = None,
                  margin: float = 10.0, seed: int = 0,
                  reduce_stl: bool = False) -> DTUScanResult:
    """Evaluate one scan: reconstruction ``data_pts`` vs GT ``stl_pts`` (mm).

    MATLAB-parity notes (each checked against the .m sources by
    tests/test_dtu_eval.py's independent line-by-line reimplementation):
      - only the DATA cloud is thinned; the official stl files ship already
        reduced to 0.2 mm density and MATLAB uses them as-is
        (PointCompareMain.m:12 comment). Pass ``reduce_stl=True`` only for
        non-official GT clouds.
      - completeness distances run against ALL reduced data points
        (PointCompareMain.m:26 uses the full Qdata); the box/mask filters
        apply to which ACCURACY distances are kept, never to the KD-tree
        targets.
      - without an ObsMask, out-of-box data points are dropped via a
        ``margin``-dilated GT bounding box — the fallback analog of
        MATLAB's Dist=MaxDist clamp for points no chunk covers
        (MaxDistCP.m:3) followed by the 20 mm cutoff.
    """
    data = reduce_points(np.asarray(data_pts, np.float64), dst, seed)
    stl = np.asarray(stl_pts, np.float64)
    if reduce_stl:
        stl = reduce_points(stl, dst, seed + 1)

    if obs_mask_file is not None:
        obs_mask, bb, res = _load_obs_mask(obs_mask_file)
        # BaseEvalMain_web.m / PointCompareMain.m:34-41: quantize to the
        # mask grid (MATLAB round = half away from zero), keep accuracy
        # points whose voxel is observed.
        q = np.floor((data - bb[0:1]) / res + 0.5).astype(np.int64)
        valid = np.all((q >= 0) & (q < np.array(obs_mask.shape)[None]),
                       axis=1)
        obs = np.zeros(data.shape[0], bool)
        obs[valid] = obs_mask[q[valid, 0], q[valid, 1], q[valid, 2]] > 0
        data_eval = data[obs]
    else:
        # fallback: GT bounding box + margin stands in for the ObsMask
        lo = stl.min(0) - margin
        hi = stl.max(0) + margin
        data_eval = data[np.all((data >= lo) & (data <= hi), axis=1)]

    if plane_file is not None:
        # PointCompareMain.m:51: completeness only above the ground plane.
        p = _load_ground_plane(plane_file)
        above = stl @ p[:3] + p[3] > 0
        stl_eval = stl[above]
    else:
        stl_eval = stl

    d_acc = cKDTree(stl).query(data_eval, k=1, workers=-1)[0]
    d_comp = cKDTree(data).query(stl_eval, k=1, workers=-1)[0]
    d_acc_in = d_acc[d_acc < max_dist]       # ComputeStat_web.m:12
    d_comp_in = d_comp[d_comp < max_dist]
    return DTUScanResult(
        scan=scan,
        mean_acc=float(d_acc_in.mean()) if d_acc_in.size else float("nan"),
        mean_comp=float(d_comp_in.mean()) if d_comp_in.size else float("nan"),
        median_acc=float(np.median(d_acc_in)) if d_acc_in.size else float("nan"),
        median_comp=float(np.median(d_comp_in)) if d_comp_in.size else float("nan"),
        n_data=int(data_eval.shape[0]), n_stl=int(stl_eval.shape[0]))


def aggregate(results: list[DTUScanResult]) -> dict[str, float]:
    """ComputeStat_web.m aggregation: unweighted mean over scans."""
    accs = np.array([r.mean_acc for r in results])
    comps = np.array([r.mean_comp for r in results])
    return {
        "mean_acc": float(np.nanmean(accs)),
        "mean_comp": float(np.nanmean(comps)),
        "overall": float(0.5 * (np.nanmean(accs) + np.nanmean(comps))),
    }
