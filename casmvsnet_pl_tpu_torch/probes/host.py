"""What a kernel launch costs the host, on the card.

The time to enqueue one call (``common.host_us``: 200 calls without waiting
for the card) of each of the port's sixteen kernel wrappers at a small
shape, where the device's work is nil; beside it PyTorch's own
``index_select`` at the lane gather's and the row gather's probe shapes,
the allocations the wrappers make (``t.new_empty``, ``t.new_zeros``), and
the pieces a launch from Python can be made of: entering
``torch.cuda.device``, building a ``Stream`` object, reading the raw
stream, looking a ctypes function up, a ctypes call, comparing
``torch.device`` objects, reading device indices.

    python -m casmvsnet_pl_tpu_torch.probes.host
"""
from __future__ import annotations

import torch

from .. import kernels as k
from . import common


def wrapper_calls(device) -> dict:
    """By wrapper name, a call of it at a small shape (the lane gather and
    the row gathers at the TPU probe's shapes)."""
    g = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    feats, dv = rand(1, 3, 16, 16, 8), rand(1, 8, 16, 16) + 400.0
    proj = torch.eye(3, 4, device=device).repeat(1, 2, 1, 1)
    proj[..., 0, 3] = 10.0
    go = rand(1, 8, 16, 16, 8)
    ref, rows, ws = rand(1, 64, 8), rand(1, 2, 4, 64, 32), rand(1, 2, 4, 64, 4)
    grad1, grad2 = rand(1, 4, 64, 8), rand(1, 4, 64, 2)
    trows, tw, tg = rand(64, 32), rand(64, 4), rand(64, 8)
    table = rand(64 * 128, 128)
    idx = torch.randint(0, table.shape[0], (256,), generator=g, device=device)
    featT = rand(8, 1024)
    idx_lane = torch.randint(0, 1024, (128,), generator=g, device=device)
    rowsT, fx = rand(2, 128, 64), rand(2, 8, 64) * 3.0
    return {
        "cost_volume_cuda": lambda: k.cost_volume_cuda(feats, proj, dv),
        "cost_volume_bwd_cuda":
            lambda: k.cost_volume_bwd_cuda(feats, proj, dv, go),
        "variance_epilogue_cuda":
            lambda: k.variance_epilogue_cuda(ref, rows, ws),
        "groupwise_epilogue_cuda":
            lambda: k.groupwise_epilogue_cuda(ref, rows, ws, 2),
        "variance_epilogue_bwd_cuda":
            lambda: k.variance_epilogue_bwd_cuda(ref, rows, ws, grad1),
        "groupwise_epilogue_bwd_cuda":
            lambda: k.groupwise_epilogue_bwd_cuda(ref, rows, ws, grad2, 2),
        "tap_reduce_cuda": lambda: k.tap_reduce_cuda(trows, tw),
        "tap_reduce_bwd_cuda": lambda: k.tap_reduce_bwd_cuda(trows, tw, tg),
        "lane_prefix_copy_cuda": lambda: k.lane_prefix_copy_cuda(trows),
        "row_gather_ldg_cuda": lambda: k.row_gather_ldg_cuda(table, idx),
        "row_gather_cp_async_cuda":
            lambda: k.row_gather_cp_async_cuda(table, idx),
        "row_gather_bulk_cuda": lambda: k.row_gather_bulk_cuda(table, idx),
        "lane_gather_cuda": lambda: k.lane_gather_cuda(featT, idx_lane),
        "variance_dblk_cuda":
            lambda: k.variance_dblk_cuda(ref, rows, ws, 2),
        "variance_v3_cuda": lambda: k.variance_v3_cuda(ref, rows, ws),
        "patch_epilogue_t_cuda":
            lambda: k.patch_epilogue_t_cuda(rowsT, fx, fx),
        "index_select (lane gather's shape)":
            lambda: featT.index_select(1, idx_lane),
        "index_select (row gather's shape)":
            lambda: table.index_select(0, idx),
        "t.new_empty (8, 128)": lambda: featT.new_empty((8, 128)),
        "t.new_zeros (1, 3, 16, 16, 8)":
            lambda: feats.new_zeros(feats.shape, dtype=torch.float32),
    }


def piece_calls(device) -> dict:
    """By name, the pieces of a launch from Python."""
    lib = k.cost_volume_cuda.build()
    a, b = torch.empty(8, device=device), torch.empty(8, device=device)
    idx = a.get_device()

    def enter_device():
        with torch.cuda.device(a.device):
            pass

    return {
        "with torch.cuda.device(t.device)": enter_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(i)":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "getattr(lib, 'lane_gather_fwd')":
            lambda: getattr(lib, "lane_gather_fwd"),
        "kernel.build()": k.lane_gather_cuda.build,
        "ctypes call (cost_volume_error_string)":
            lambda: lib.cost_volume_error_string(0),
        "torch.empty(shape, dtype=t.dtype, device=t.device)":
            lambda: torch.empty((8, 128), dtype=a.dtype, device=a.device),
        "torch.empty(shape, dtype=t.dtype, device=i)":
            lambda: torch.empty((8, 128), dtype=a.dtype, device=idx),
        "t.new_empty(shape)": lambda: a.new_empty((8, 128)),
        "t.is_cuda and t.device == u.device":
            lambda: a.is_cuda and a.device == b.device,
        "t.get_device() == u.get_device()":
            lambda: a.get_device() == b.get_device(),
    }


def measure(calls: dict, iters: int = 200) -> dict:
    """host_us of each call, in turns: the list, then the list reversed;
    by name the mean of the two turns."""
    first = {n: common.host_us(fn, iters) for n, fn in calls.items()}
    second = {n: common.host_us(fn, iters)
              for n, fn in reversed(calls.items())}
    return {n: (first[n] + second[n]) / 2 for n in calls}


def main(device="cuda", card_name: str | None = None) -> dict:
    """Print and return by name the host time (us) of every wrapper, of
    the PyTorch calls beside them, and of the pieces of a launch."""
    card_name = card_name or common.card()
    times = measure(wrapper_calls(device))
    times.update(measure(piece_calls(device), 1000))
    for name, us in times.items():
        print(f"host_us {name}: {us!r} us [{card_name}]", flush=True)
    return times


if __name__ == "__main__":
    main()
