"""Training CLI flags of ``train_torch.py``.

The flags of ``casmvsnet_pl_tpu/opt.py`` with the same names, defaults and
choices (``--num_gpus`` an alias of ``--num_devices``; ``window`` sampling
behind the same environment variable), plus ``--cpu``, as in
``eval_torch.py``. What the port does with each is in ``train_torch.py``'s
docstring.
"""
from __future__ import annotations

import argparse
import os

from .models import ARCHS


def sampling_choices():
    """CLI-reachable sampling modes: exact modes only.

    ``window`` sampling is a bounded approximation (it clamps bilinear
    supports that exceed the packed strip), so it is not offered as a
    normal choice; ``CASMVS_ENABLE_WINDOW_SAMPLING=1`` lists it, as in the
    JAX package (``ops/plane_sweep.py::window_cost_volume``).
    """
    choices = ['auto', 'quad', 'patch']
    if os.environ.get('CASMVS_ENABLE_WINDOW_SAMPLING') == '1':
        choices.append('window')
    return choices


def get_opts(argv=None):
    parser = argparse.ArgumentParser()

    parser.add_argument('--root_dir', type=str,
                        default='/data/mvs_training/dtu/',
                        help='root directory of the dataset')
    parser.add_argument('--dataset_name', type=str, default='dtu',
                        choices=['dtu', 'blendedmvs'],
                        help='which dataset to train/val')
    parser.add_argument('--n_views', type=int, default=3,
                        help='number of views (including ref) used in training')
    parser.add_argument('--levels', type=int, default=3, choices=[3],
                        help='number of FPN levels (fixed to 3)')
    parser.add_argument('--depth_interval', type=float, default=2.65,
                        help='depth interval for the finest level, unit in mm')
    parser.add_argument('--n_depths', nargs='+', type=int, default=[8, 32, 48],
                        help='number of depths in each level (fine->coarse)')
    parser.add_argument('--interval_ratios', nargs='+', type=float,
                        default=[1.0, 2.0, 4.0],
                        help='depth interval ratio per level (fine->coarse)')
    parser.add_argument('--num_groups', type=int, default=1,
                        choices=[1, 2, 4, 8],
                        help='groups in groupwise correlation (divisor of 8)')
    parser.add_argument('--arch', type=str, default='casmvsnet',
                        choices=list(ARCHS),
                        help='the model: CasMVSNet, or TransMVSNet')
    parser.add_argument('--loss_type', type=str, default='sl1',
                        choices=['sl1'],
                        help="loss to use (CasMVSNet's; each model trains "
                             "with its own objective: --arch transmvsnet "
                             'with its focal loss)')

    parser.add_argument('--batch_size', type=int, default=1)
    parser.add_argument('--num_epochs', type=int, default=16)
    parser.add_argument('--num_devices', '--num_gpus', type=int, default=0,
                        dest='num_devices',
                        help='number of processes for data parallelism, '
                             'one a card (0 = every visible card; one '
                             'process with --cpu)')

    parser.add_argument('--ckpt_path', type=str, default='',
                        help='pretrained checkpoint path to load')
    parser.add_argument('--resume_path', type=str, default='',
                        help='checkpoint to FULLY resume from (params + '
                             'batch stats + optimizer state + step); the '
                             'reference can only warm-start weights')
    parser.add_argument('--prefixes_to_ignore', nargs='+', type=str,
                        default=['loss'],
                        help='prefixes to ignore in the checkpoint')

    parser.add_argument('--optimizer', type=str, default='sgd',
                        choices=['sgd', 'adam', 'radam', 'ranger'])
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--weight_decay', type=float, default=1e-5)
    parser.add_argument('--lr_scheduler', type=str, default='steplr',
                        choices=['steplr', 'cosine', 'poly'])
    parser.add_argument('--warmup_multiplier', type=float, default=1.0)
    parser.add_argument('--warmup_epochs', type=int, default=0)
    parser.add_argument('--decay_step', nargs='+', type=int, default=[20])
    parser.add_argument('--decay_gamma', type=float, default=0.1)
    parser.add_argument('--poly_exp', type=float, default=0.9)

    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'f32'],
                        help='compute precision (parameters, BatchNorm '
                             'statistics and depth math stay f32)')
    parser.add_argument('--use_amp', default=False, action='store_true',
                        help='alias of --precision bf16 (kept for '
                             'compatibility)')
    parser.add_argument('--remat', default=False, action='store_true',
                        help='accepted for compatibility; no effect in the '
                             'port (the default route stores no warped '
                             'volume, see train_torch.py)')
    parser.add_argument('--sampling', type=str, default='auto',
                        choices=sampling_choices(),
                        help='plane-sweep sampling strategy (auto and patch: '
                             'the fused cost-volume kernels; quad: packed-'
                             'quad rows and the cost epilogue kernels; '
                             'window: depth groups sharing a clamped window '
                             'where C <= 8, the fused kernels elsewhere). '
                             'All modes but window are exact; "window" is '
                             'listed only with '
                             'CASMVS_ENABLE_WINDOW_SAMPLING=1.')
    parser.add_argument('--num_workers', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--exp_name', type=str, default='exp')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='train on the CPU instead of the card')

    return parser.parse_args(argv)
