"""Inference to PFM depth maps and their fusion into a point cloud, with
the PyTorch port on one NVIDIA GPU.

The port's counterpart of ``eval.py``, with the same flags and outputs,
for DTU, Tanks and Temples and BlendedMVS (``--dataset_name``):

    python eval_torch.py --root_dir <DTU root> --split test --scan scan1
    python eval_torch.py --dataset_name tanks --root_dir <TNT root> \
        --split intermediate --scan Family

Step 1 (:func:`run_inference`) runs the cascade forward for each reference
view and writes ``depth_{vid:04d}.pfm`` (full resolution) and
``proba_{vid:04d}.pfm`` (quarter resolution) under
``results/<dataset>/depth/<scan>`` (with ``--save_visual`` also
``depth_visual_*.jpg``, JET-coloured, and ``proba_visual_*.jpg``, the
confidence mask, as ``cv2.imwrite`` writes them); step 2
(:func:`run_fusion`) fuses them into
``results/<dataset>/points/<scan>.ply`` through confidence and
geometric-consistency filtering with iterative refinement. Both run on the
card; ``--cpu`` runs them on the CPU. Without a card and without
``--cpu`` the script exits with an error.

Fusion reads each view's colours as ``eval.py`` does with
``cv2.imread``: a JPEG turned by its EXIF orientation (the model's inputs,
read as PIL reads them, are not turned). ``--fusion_backend`` does not
exist, since the port has one fusion backend.
"""
from __future__ import annotations

import functools
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from casmvsnet_pl_tpu_torch.data import dataset_dict, read_pfm, save_pfm
from casmvsnet_pl_tpu_torch.data.base import load_image_cv2, resize_linear
from casmvsnet_pl_tpu_torch.data.jpeg import write_jpeg
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.fusion import fuse_and_write
from casmvsnet_pl_tpu_torch.models import ARCHS, CascadeMVSNet, build_model
from casmvsnet_pl_tpu_torch.opt import sampling_choices
from casmvsnet_pl_tpu_torch.utils import extract_model_params, load_checkpoint
from casmvsnet_pl_tpu_torch.utils.visualization import COLORMAPS


def get_opts(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--root_dir', type=str,
                        default='/data/DTU/mvs_training/dtu/')
    parser.add_argument('--dataset_name', type=str, default='dtu',
                        choices=['dtu', 'tanks', 'blendedmvs'])
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--scan', type=str, default='',
                        help='specify scan to evaluate (must be in the split)')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='run inference and fusion on the CPU instead '
                             'of the card')
    # depth prediction
    parser.add_argument('--arch', type=str, default='casmvsnet',
                        choices=list(ARCHS),
                        help='the model: CasMVSNet or TransMVSNet (its '
                             'volume is the one-group correlation)')
    parser.add_argument('--n_views', type=int, default=5)
    parser.add_argument('--depth_interval', type=float, default=2.65)
    parser.add_argument('--n_depths', nargs='+', type=int, default=[8, 32, 48])
    parser.add_argument('--interval_ratios', nargs='+', type=float,
                        default=[1.0, 2.0, 4.0])
    parser.add_argument('--num_groups', type=int, default=1,
                        choices=[1, 2, 4, 8])
    parser.add_argument('--img_wh', nargs="+", type=int, default=[1152, 864],
                        help='resolution (img_w, img_h), multiples of 32')
    parser.add_argument('--ckpt_path', type=str, default='',
                        help='a checkpoint of the port (utils/checkpoints.py)')
    parser.add_argument('--save_visual', default=False, action='store_true')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'f32'])
    parser.add_argument('--sampling', type=str, default='auto',
                        choices=sampling_choices(),
                        help='plane-sweep sampling strategy (all listed '
                             'modes are exact; the approximate "window" '
                             'mode needs CASMVS_ENABLE_WINDOW_SAMPLING=1)')
    # point cloud fusion
    parser.add_argument('--conf', type=float, default=0.999,
                        help='min confidence for a pixel to be valid')
    parser.add_argument('--min_geo_consistent', type=int, default=5,
                        help='min consistent views for a pixel to be valid')
    parser.add_argument('--max_ref_views', type=int, default=400)
    parser.add_argument('--skip', type=int, default=1,
                        help='point subsampling when building the cloud')
    parser.add_argument('--fusion_cache_gb', type=float, default=4.0,
                        help='host-RAM budget for the fusion refinement '
                             'cache; overflow spills to disk (0 = keep '
                             'everything in memory)')
    parser.add_argument('--skip_inference', default=False, action='store_true',
                        help='reuse existing depth predictions (fusion only)')
    parser.add_argument('--skip_fusion', default=False, action='store_true')
    return parser.parse_args(argv)


def resolve_device(args) -> torch.device:
    """The card, or the CPU with ``--cpu``; without a card, exit."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("eval_torch.py: no CUDA device; pass --cpu to run "
                         "on the CPU")
    return torch.device("cuda")


class Predictor:
    """The cascade forward of step 1: ``(depth_0, confidence_2)``."""

    def __init__(self, model: CascadeMVSNet, device: torch.device):
        self.model, self.device = model, device

    def __call__(self, imgs, proj_mats, init_depth_min, depth_interval,
                 cost_volume=None):
        """imgs (B, V, H, W, 3) and proj_mats (B, V-1, 3, 3, 4) tensors on
        the device; ``cost_volume`` replaces the model's own, only to
        compare it with a plain version."""
        with torch.inference_mode():
            out = self.model(imgs, proj_mats, init_depth_min,
                             depth_interval, cost_volume=cost_volume)
        return out["depth_0"], out["confidence_2"]


def build_predictor(args) -> Predictor:
    """The model at ``--precision`` on the device, with the weights of
    ``--ckpt_path`` (state-dict names of the port's trainer) or, without
    one, seeded random weights."""
    device = resolve_device(args)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = build_model(args.arch, args.n_depths,
                        args.interval_ratios, args.num_groups, args.sampling)
    if args.ckpt_path:
        ckpt = load_checkpoint(args.ckpt_path)
        model.load_state_dict({**extract_model_params(ckpt),
                               **ckpt.get("batch_stats", {})}, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    return Predictor(model.to(device=device, dtype=dtype).eval(), device)


def run_inference(args, dataset, scans, predict: Predictor | None = None
                  ) -> list[dict]:
    """Step 1 for the views of ``--scan`` (every view without it). Returns
    one record a view: scan, vid, the forward's ms (CUDA events on the
    card) and the view's ms with its reading and writing."""
    predict = predict or build_predictor(args)
    device = predict.device
    depth_dir = f'results/{args.dataset_name}/depth'
    print('Creating depth and confidence predictions...')
    if args.scan:
        data_range = [i for i, x in enumerate(dataset.metas)
                      if x[0] == args.scan]
    else:
        data_range = range(len(dataset))
    records = []
    for n, i in enumerate(data_range):
        t0 = time.perf_counter()
        sample = dataset[i]
        scan, vid = sample['scan_vid']
        os.makedirs(os.path.join(depth_dir, scan), exist_ok=True)
        imgs = torch.from_numpy(sample['imgs'][None]).to(device)
        proj = torch.from_numpy(sample['proj_mats'][None]).to(device)
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t1 = time.perf_counter()
        depth, proba = predict(imgs, proj, float(sample['init_depth_min']),
                               float(sample['depth_interval']))
        if device.type == "cuda":
            events[1].record()
        depth = np.nan_to_num(depth[0].float().cpu().numpy())
        proba = np.nan_to_num(proba[0].float().cpu().numpy())  # 1/4 scale
        forward_ms = (events[0].elapsed_time(events[1])
                      if device.type == "cuda"
                      else (time.perf_counter() - t1) * 1e3)
        save_pfm(os.path.join(depth_dir, f'{scan}/depth_{vid:04d}.pfm'), depth)
        save_pfm(os.path.join(depth_dir, f'{scan}/proba_{vid:04d}.pfm'), proba)
        if args.save_visual:
            save_visuals(os.path.join(depth_dir, scan), vid, depth, proba,
                         args.conf)
        view_ms = (time.perf_counter() - t0) * 1e3
        records.append({"scan": scan, "vid": vid, "forward_ms": forward_ms,
                        "view_ms": view_ms})
        print(f"[{n + 1}/{len(data_range)}] {scan} view {vid}: forward "
              f"{forward_ms:.1f} ms, view {view_ms:.1f} ms", flush=True)
    return records


def save_visuals(out_dir: str, vid: int, depth: np.ndarray,
                 proba: np.ndarray, conf: float) -> None:
    """``depth_visual_{vid:04d}.jpg`` (depth normalized over its positive
    range, JET-coloured) and ``proba_visual_{vid:04d}.jpg`` (255 where the
    confidence passes ``conf``), the files ``eval.py`` writes with
    ``cv2.applyColorMap`` and ``cv2.imwrite``."""
    mi = np.min(depth[depth > 0]) if (depth > 0).any() else 0
    ma = np.max(depth)
    vis = (255 * (depth - mi) / (ma - mi + 1e-8)).astype(np.uint8)
    write_jpeg(os.path.join(out_dir, f'depth_visual_{vid:04d}.jpg'),
               COLORMAPS["jet"][vis])
    write_jpeg(os.path.join(out_dir, f'proba_visual_{vid:04d}.jpg'),
               (255 * (proba > conf)).astype(np.uint8))


def read_image(path: str, img_wh) -> np.ndarray:
    """An image as RGB uint8 at ``img_wh``, read as ``eval.py``'s fusion
    reads its colours: ``cv2.imread`` (a JPEG turned by its EXIF
    orientation), then a resize with OpenCV's ``INTER_LINEAR`` semantics
    (the model's inputs use PIL's filter, ``data/base.py::load_image``)."""
    img = torch.from_numpy(load_image_cv2(path)).float()
    img = resize_linear(img, tuple(img_wh))
    return img.round().clamp(0, 255).to(torch.uint8).numpy()


def run_fusion(args, dataset, scans) -> None:
    """Step 2 for each scan of ``scans``."""
    device = resolve_device(args)
    point_dir = f'results/{args.dataset_name}/points'
    depth_dir = f'results/{args.dataset_name}/depth'
    os.makedirs(point_dir, exist_ok=True)
    print('Fusing point clouds...')

    for scan in scans:
        print(f'Processing {scan} ...')
        metas = [(m[2], m[3]) for m in dataset.metas if m[0] == scan]
        n = fuse_and_write(
            f'{point_dir}/{scan}.ply', metas,
            lambda vid: read_image(dataset.image_path(scan, vid),
                                   args.img_wh),
            lambda vid: read_pfm(f'{depth_dir}/{scan}/depth_{vid:04d}.pfm')[0],
            lambda vid: read_pfm(f'{depth_dir}/{scan}/proba_{vid:04d}.pfm')[0],
            functools.partial(dataset.proj_mat, scan), tuple(args.img_wh),
            conf=args.conf, min_geo_consistent=args.min_geo_consistent,
            max_ref_views=args.max_ref_views, skip=args.skip, progress=True,
            cache_bytes=(args.fusion_cache_gb * 1e9
                         if args.fusion_cache_gb > 0 else None),
            device=device)
        print(f'{scan} contains {n / 1e6:.2f} M points')
    print('Done!')


def main(argv=None) -> int:
    args = get_opts(argv)
    resolve_device(args)
    dataset = dataset_dict[args.dataset_name](
        args.root_dir, args.split, n_views=args.n_views,
        depth_interval=args.depth_interval, img_wh=tuple(args.img_wh))
    scans = [args.scan] if args.scan else dataset.scans
    if not args.skip_inference:
        run_inference(args, dataset, scans)
    if not args.skip_fusion:
        run_fusion(args, dataset, scans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
