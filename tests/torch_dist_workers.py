"""Rank functions for ``tests/test_torch_port_dist.py``, in a module of
their own that imports neither JAX nor the test module, so that the ranks
that ``casmvsnet_pl_tpu_torch.parallel.spawn`` starts import them quickly.
Each takes ``(rank, world, device, ...)`` and saves what it computed to a
file per rank."""
import torch

from casmvsnet_pl_tpu_torch.entry import data_parallel_step
from casmvsnet_pl_tpu_torch.losses import sl1_loss
from casmvsnet_pl_tpu_torch.parallel import shard_batch


def steps(rank, world, device, specs):
    """``entry.data_parallel_step`` for each spec, in one process group."""
    for spec in specs:
        data_parallel_step(rank, world, device, spec)


def loss_shares(rank, world, device, data, out):
    """This rank's global-count loss (and its gradient with respect to
    the predictions) and its own per-rank masked mean, on its rows of
    ``data`` (numpy: 'results', 'depths', 'masks')."""
    mine = shard_batch(data, rank, world)
    results = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in mine["results"].items()}
    depths = {k: torch.from_numpy(v) for k, v in mine["depths"].items()}
    masks = {k: torch.from_numpy(v) for k, v in mine["masks"].items()}
    share = sl1_loss(results, depths, masks, distributed=True)
    share.backward()
    own = sl1_loss(results, depths, masks)
    torch.save({"share": float(share), "own": float(own),
                "grads": {k: v.grad.numpy() for k, v in results.items()}},
               f"{out}.{rank}")


