"""Convert a checkpoint written outside the port into one of the port.

    python convert_ckpt_torch.py _ckpt_/epoch.15.ckpt out/ref.ckpt
    python convert_ckpt_torch.py ckpts/exp/last.ckpt out/from_jax.ckpt

SRC is a reference (kwea123/CasMVSNet_pl) PyTorch-Lightning ``.ckpt`` or
plain ``.pth`` state dict, zip or legacy format, or a checkpoint of the
JAX package (flax msgpack); the format is told from the file's first
bytes. DST is written with the port's ``save_checkpoint`` and loads with
``strict=True`` wherever a checkpoint of the port loads: ``eval_torch.py
--ckpt_path``, ``train_torch.py --ckpt_path`` and ``demo_torch.py
--ckpt_path``. ``--arch`` names the model (CasMVSNet, the default;
TransMVSNet is refused: the port holds no converter for its published
checkpoints). The counterpart of ``scripts/convert_torch_ckpt.py``;
``casmvsnet_pl_tpu_torch/utils/torch_convert.py`` says how the files are
read (a Lightning file's pickle only through an allow-list).
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser

from casmvsnet_pl_tpu_torch.models import ARCHS
from casmvsnet_pl_tpu_torch.utils import convert_checkpoint, save_checkpoint


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("src", help="reference .ckpt/.pth or JAX checkpoint")
    parser.add_argument("dst", help="output checkpoint of the port")
    parser.add_argument("--arch", default="casmvsnet", choices=list(ARCHS),
                        help="the model whose checkpoint SRC holds")
    args = parser.parse_args(argv)
    if args.arch != "casmvsnet":
        raise SystemExit(
            f"convert_ckpt_torch.py: --arch {args.arch} has no converter: "
            "the port reads CasMVSNet checkpoints only (TransMVSNet's "
            "published weights are not mapped)")
    ckpt = convert_checkpoint(args.src)
    save_checkpoint(args.dst, ckpt)
    n = sum(v.numel() for v in ckpt["params"].values())
    print(f"wrote {args.dst}: {len(ckpt['params'])} parameter tensors, "
          f"{n / 1e6:.2f}M params")
    return ckpt


if __name__ == "__main__":
    main()
    sys.exit(0)
