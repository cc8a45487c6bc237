"""BatchNorm over the global batch of a data-parallel step.

The JAX trainer computes its BatchNorm statistics over the whole sharded
batch (``engine/trainer.py``'s jitted step, the batch on the mesh's
``data`` axis): the mean and variance of each channel are those of every
rank's rows together. :func:`sync_batch_norm` does the same across the
ranks of a process group, as a ``torch.autograd.Function``:

- forward: one all-reduce of the float32 per-channel sums of ``x - K``
  and ``(x - K)^2`` and of the value count, ``K`` the running mean (equal
  on every rank, so the shifted sums add up; shifting keeps the variance
  from cancelling once the running mean has moved towards the data's);
  the output normalized with the global biased variance; the running
  statistics moved with flax's rule (biased variance, global count n),
  as ``models/blocks.py::_FlaxBatchNorm`` moves them on one process;
- backward: one all-reduce of the per-channel sums of dy and of
  dy * x_hat, so that each rank's input gradient is that of the sum of
  every rank's loss; the affine parameters get their rank's own sums,
  which ``DistributedDataParallel`` averages with the other gradients.

Statistics and arithmetic are float32 for a bf16 (autocast) or float32
input, float64 for a float64 one; the output has the input's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _channel_view(t: Tensor, ndim: int) -> Tensor:
    return t.reshape((1, -1) + (1,) * (ndim - 2))


class _SyncBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        with torch.autocast(x.device.type, enabled=False):
            dims = [0] + list(range(2, x.ndim))
            acc = torch.promote_types(x.dtype, torch.float32)
            shift = _channel_view(running_mean.to(acc), x.ndim)
            xs = x.to(acc) - shift
            n_local = x.numel() // x.shape[1]
            stats = torch.cat([xs.sum(dims), (xs * xs).sum(dims),
                               xs.new_full((1,), float(n_local))])
            dist.all_reduce(stats)
            C = x.shape[1]
            n = stats[2 * C]
            mean_s = stats[:C] / n
            var = (stats[C:2 * C] / n - mean_s * mean_s).clamp(min=0.0)
            mean = shift.flatten() + mean_s
            invstd = torch.rsqrt(var + eps)
            xhat = (xs - _channel_view(mean_s, x.ndim)) * \
                _channel_view(invstd, x.ndim)
            y = xhat * _channel_view(weight.to(acc), x.ndim) + \
                _channel_view(bias.to(acc), x.ndim)
            with torch.no_grad():
                running_mean.mul_(1.0 - momentum).add_(
                    momentum * mean.to(running_mean.dtype))
                running_var.mul_(1.0 - momentum).add_(
                    momentum * var.to(running_var.dtype))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count = n
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dims = [0] + list(range(2, x.ndim))
            C = x.shape[1]
            xhat = (x.to(mean.dtype) - _channel_view(mean, x.ndim)) * \
                _channel_view(invstd, x.ndim)
            dyf = dy.to(mean.dtype)
            sum_dy = dyf.sum(dims)
            sum_dy_xhat = (dyf * xhat).sum(dims)
            local = torch.cat([sum_dy, sum_dy_xhat])
            total = local.clone()
            dist.all_reduce(total)
            n = ctx.count
            dx = (dyf - _channel_view(total[:C] / n, x.ndim)
                  - xhat * _channel_view(total[C:] / n, x.ndim)) * \
                _channel_view(weight.to(mean.dtype) * invstd, x.ndim)
        return (dx.to(x.dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None, None, None)


def sync_batch_norm(x: Tensor, weight: Tensor, bias: Tensor,
                    running_mean: Tensor, running_var: Tensor,
                    momentum: float, eps: float) -> Tensor:
    """Train-mode BatchNorm of ``x`` (N, C, ...) over every rank's batch;
    moves ``running_mean`` and ``running_var`` in place."""
    return _SyncBatchNorm.apply(x, weight, bias, running_mean, running_var,
                                momentum, eps)
