"""Run one sample through the port's CascadeMVSNet on the card and draw it.

The port's counterpart of ``demo.py`` (the reference's ``test.ipynb``:
load a checkpoint, run one DTU test sample, show depth, confidence and the
2 mm error map, time the forward), with the same flags:

    python demo_torch.py --ckpt_path ckpts/exp/best.ckpt \
        --root_dir /data/DTU/mvs_training/dtu --scan scan9 --view 22
    python demo_torch.py            # synthetic plane scene, random weights

``--ckpt_path`` takes a checkpoint of the port; a reference Lightning
``.ckpt`` or a checkpoint of the JAX package is converted first with
``convert_ckpt_torch.py``. The model is ``CascadeMVSNet`` at its default
config. It runs on the card; ``--cpu`` runs it on the CPU, and without a
card and without ``--cpu`` the script exits with an error.

The figure is one PNG row of panels, each the sample's size: the
reference image, the predicted depth (JET), the confidence (BONE) and,
where the sample has ground truth, the ground-truth depth and the 2 mm
map (white where the depth is within 2 mm). It is drawn with
``utils/visualization.py`` and written with ``data/png.py``, without
matplotlib, and has no titles: they are printed.
"""
from __future__ import annotations

import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from casmvsnet_pl_tpu_torch.data import PlaneScene, dataset_dict
from casmvsnet_pl_tpu_torch.data.base import unnormalize_image
from casmvsnet_pl_tpu_torch.data.png import write_png
from casmvsnet_pl_tpu_torch.entry import init_weights
from casmvsnet_pl_tpu_torch.models import CascadeMVSNet
from casmvsnet_pl_tpu_torch.utils import extract_model_params, load_checkpoint
from casmvsnet_pl_tpu_torch.utils.visualization import (visualize_depth,
                                                        visualize_prob)


def get_opts(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--root_dir', type=str, default='',
                        help='DTU root; empty = synthetic plane scene')
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--scan', type=str, default='scan9')
    parser.add_argument('--view', type=int, default=22)
    parser.add_argument('--n_views', type=int, default=3)
    parser.add_argument('--depth_interval', type=float, default=2.65)
    parser.add_argument('--img_wh', nargs='+', type=int, default=[640, 512])
    parser.add_argument('--num_groups', type=int, default=1)
    parser.add_argument('--ckpt_path', type=str, default='',
                        help='a checkpoint of the port (convert_ckpt_torch.py '
                             'converts the others)')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'f32'])
    parser.add_argument('--out_png', type=str, default='demo_torch.png')
    parser.add_argument('--time_iters', type=int, default=10,
                        help='timing loop iterations (0 to skip)')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='run on the CPU instead of the card')
    return parser.parse_args(argv)


def resolve_device(args) -> torch.device:
    """The card, or the CPU with ``--cpu``; without a card, exit."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("demo_torch.py: no CUDA device; pass --cpu to run "
                         "on the CPU")
    return torch.device("cuda")


def load_sample(args) -> dict:
    """The DTU sample of ``--scan`` / ``--view`` (``--root_dir``), or
    ``demo.py``'s synthetic plane scene at ``--img_wh``."""
    if args.root_dir:
        dataset = dataset_dict['dtu'](
            args.root_dir, args.split, n_views=args.n_views,
            depth_interval=args.depth_interval, img_wh=tuple(args.img_wh))
        idx = next(i for i, m in enumerate(dataset.metas)
                   if m[0] == args.scan and m[2] == args.view)
        return dataset[idx]
    W, H = args.img_wh
    scene = PlaneScene(img_wh=(W, H), n_views=args.n_views, z0=460.0,
                       baseline=12.0, focal=600.0, slope_x=0.2)
    imgs, proj, depths = scene.model_inputs()
    return {'imgs': imgs[0], 'proj_mats': proj[0],
            'init_depth_min': np.float32(425.0),
            'depth_interval': np.float32(2.65),
            'depths': {k: v[0] for k, v in depths.items()},
            'masks': {k: np.ones(v[0].shape, bool)
                      for k, v in depths.items()},
            'scan_vid': ('synthetic', 0)}


def build_model(args, device: torch.device) -> CascadeMVSNet:
    """``CascadeMVSNet(num_groups)`` at ``--precision`` on ``device``, in
    eval mode, with the weights of ``--ckpt_path`` (``strict=True``) or,
    without one, seeded random weights."""
    model = CascadeMVSNet(num_groups=args.num_groups)
    if args.ckpt_path:
        ckpt = load_checkpoint(args.ckpt_path)
        model.load_state_dict({**extract_model_params(ckpt),
                               **ckpt.get("batch_stats", {})}, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    return model.to(device=device, dtype=dtype).eval()


def model_inputs(sample: dict, device: torch.device) -> tuple:
    """(imgs (1, V, H, W, 3), proj_mats (1, V-1, 3, 3, 4), depth_min,
    depth_interval) of a sample, on ``device``."""
    return (torch.from_numpy(sample['imgs'][None]).to(device),
            torch.from_numpy(sample['proj_mats'][None]).to(device),
            float(sample['init_depth_min']), float(sample['depth_interval']))


def predict(model: CascadeMVSNet, inputs: tuple
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward: (depth_0 (1, H, W), confidence_0 (1, H, W))."""
    with torch.inference_mode():
        out = model(*inputs)
    return out['depth_0'], out['confidence_0']


def time_forward(model, inputs, iters: int, device: torch.device) -> float:
    """ms per forward over ``iters`` forwards: CUDA events after a
    synchronize on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            predict(model, inputs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        predict(model, inputs)
    return (time.perf_counter() - t0) * 1e3 / iters


def panels(sample: dict, depth: np.ndarray, conf: np.ndarray
           ) -> tuple[list[tuple[np.ndarray, str]], float | None]:
    """The figure's panels (RGB in [0, 1], title) and ``acc_2mm`` (None
    without ground truth)."""
    out = [(unnormalize_image(np.asarray(sample['imgs'][0])), 'ref image'),
           (visualize_depth(depth), 'predicted depth'),
           (visualize_prob(conf), 'confidence')]
    if 'depths' not in sample:
        return out, None
    gt = np.asarray(sample['depths']['level_0'], np.float32)
    mask = np.asarray(sample['masks']['level_0'])
    err2 = (np.abs(depth - gt) < 2) & mask
    acc2 = float(err2.sum() / max(mask.sum(), 1))
    out.append((visualize_depth(gt), 'GT depth'))
    out.append((np.stack([err2 * 1.0] * 3, -1), f'acc_2mm={acc2:.4f}'))
    return out, acc2


def main(argv=None) -> dict:
    """Returns depth and confidence (numpy (H, W)), ``acc_2mm``,
    ``ms_per_view`` (None with ``--time_iters 0``) and the PNG's path."""
    args = get_opts(argv)
    device = resolve_device(args)
    model = build_model(args, device)
    sample = load_sample(args)
    inputs = model_inputs(sample, device)

    t0 = time.perf_counter()
    depth, conf = predict(model, inputs)
    depth = depth[0].float().cpu().numpy()
    conf = conf[0].float().cpu().numpy()
    print(f'first run: {time.perf_counter() - t0:.2f}s')
    ms = None
    if args.time_iters:
        ms = time_forward(model, inputs, args.time_iters, device)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(f'inference: {ms:.1f} ms/view ({1e3 / ms:.1f} views/s) on '
              f'{name}')

    figure, acc2 = panels(sample, depth, conf)
    if acc2 is not None:
        print(f'acc_2mm = {acc2:.4f}')
    row = np.concatenate([np.clip(img, 0, 1) for img, _ in figure], axis=1)
    write_png(args.out_png, (row * 255 + 0.5).astype(np.uint8))
    print(f'wrote {args.out_png}: ' + ' | '.join(t for _, t in figure))
    return {"depth": depth, "confidence": conf, "acc_2mm": acc2,
            "ms_per_view": ms, "png": args.out_png}


if __name__ == '__main__':
    main()
    sys.exit(0)
