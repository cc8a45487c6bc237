"""The plain versions of the weighted 4-tap reduce (TPU kernels #7/#8)
against the JAX package's.

The reference is ``scripts/kernel_tap_reduce.py::weighted_tap_reduce`` and
its custom VJP, imported by path. On the CPU it runs ``_xla_reduce`` and the
CPU branch of ``_vjp_bwd``, the formulations the Pallas kernels are held
against. It takes the weights as (4, N), tap-major; the port as (N, 4).
N = 37 is no multiple of the TPU kernel's 1024-row tile. Bound 1e-5, abs and
rel: d w sums its channels in another order.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import tap_reduce_bwd_cuda, tap_reduce_cuda
from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce
from casmvsnet_pl_tpu_torch.ops import tap_reduce as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "kernel_tap_reduce", os.path.join(REPO, "scripts", "kernel_tap_reduce.py"))
ktr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ktr)

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def inputs(rng, C, N=37):
    """rows (N, 4C), w (N, 4) f32 with some zero weights (taps outside the
    image), g (N, C) f32."""
    rows = rng.rand(N, 4 * C).astype(np.float32)
    w = rng.rand(N, 4).astype(np.float32)
    w[rng.rand(N, 4) < 0.2] = 0.0
    g = rng.randn(N, C).astype(np.float32)
    return rows, w, g


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_tap_reduce_matches_jax(C, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(C + len(dtype))
    rows, w, g = inputs(rng, C)
    jrows = jnp.asarray(rows, jdt)
    out, vjp = jax.vjp(lambda r, wt: ktr.weighted_tap_reduce(r, wt, C),
                       jrows, jnp.asarray(w.T))
    d_rows, d_wt = vjp(jnp.asarray(g))

    trows = torch.from_numpy(rows).to(tdt)
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)
    got = tr.plain_tap_reduce(trows, tw)
    assert got.shape == (37, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    gd_rows, gd_w = tr.plain_tap_reduce_bwd(trows, tw, tg)
    assert gd_rows.dtype == tdt and gd_w.dtype == torch.float32
    np.testing.assert_allclose(gd_rows.float().numpy(),
                               np.asarray(d_rows.astype(jnp.float32)),
                               err_msg="d rows", **TOL)
    np.testing.assert_allclose(gd_w.numpy(), np.asarray(d_wt).T,
                               err_msg="d w", **TOL)


def test_plain_tap_reduce_takes_leading_dimensions():
    rng = np.random.RandomState(3)
    rows, w, g = (torch.from_numpy(a) for a in inputs(rng, 8, N=2 * 3 * 5))
    flat = tr.plain_tap_reduce(rows, w)
    torch.testing.assert_close(
        tr.plain_tap_reduce(rows.reshape(2, 3, 5, 32), w.reshape(2, 3, 5, 4)),
        flat.reshape(2, 3, 5, 8), rtol=0, atol=0)
    d = tr.plain_tap_reduce_bwd(rows.reshape(2, 15, 32), w.reshape(2, 15, 4),
                                g.reshape(2, 15, 8))
    for got, want in zip(d, tr.plain_tap_reduce_bwd(rows, w, g)):
        torch.testing.assert_close(got.reshape(want.shape), want, rtol=0,
                                   atol=0)


def _old_taps(rows, ws, C):
    """The cost epilogue's 4-tap reduce as it was written before it called
    plain_tap_reduce."""
    r = rows.float()
    o = r[..., :C] * ws[..., 0:1]
    for q in range(1, 4):
        o = o + r[..., q * C:(q + 1) * C] * ws[..., q:q + 1]
    return o


def _old_grads_of_rows(rows, ws, dos):
    """The cost epilogue's d rows / d ws as written before it called
    plain_tap_reduce_bwd."""
    C = rows.shape[-1] // 4
    drows, dws = [], []
    for v, do in enumerate(dos):
        r = rows[:, v].float()
        w = ws[:, v]
        drows.append(torch.cat([do * w[..., q:q + 1] for q in range(4)], -1))
        dws.append(torch.stack([(r[..., q * C:(q + 1) * C] * do).sum(-1)
                                for q in range(4)], -1))
    return torch.stack(drows, 1).to(rows.dtype), torch.stack(dws, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cost_epilogue_reduce_keeps_its_bits(dtype):
    """The cost epilogue's plain versions reduce each view with
    plain_tap_reduce(_bwd): the same bits as their own formulas gave."""
    tdt = DTYPES[dtype][0]
    rng = np.random.RandomState(9)
    C, S = 16, 2
    rows = torch.from_numpy(rng.rand(2, S, 3, 37, 4 * C).astype(np.float32)
                            ).to(tdt)
    ws = torch.from_numpy(rng.rand(2, S, 3, 37, 4).astype(np.float32))
    dos = [torch.from_numpy(rng.randn(2, 3, 37, C).astype(np.float32))
           for _ in range(S)]
    for v in range(S):
        torch.testing.assert_close(tr.plain_tap_reduce(rows[:, v], ws[:, v]),
                                   _old_taps(rows[:, v], ws[:, v], C),
                                   rtol=0, atol=0)
    for got, want in zip(ce._grads_of_rows(rows, ws, dos),
                         _old_grads_of_rows(rows, ws, dos)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(5)
    rows, w, g = (torch.from_numpy(a) for a in inputs(rng, 16))
    before = tap_reduce_cuda.launches, tap_reduce_bwd_cuda.launches
    torch.testing.assert_close(tr.tap_reduce(rows, w),
                               tr.plain_tap_reduce(rows, w), rtol=0, atol=0)
    for got, want in zip(tr.tap_reduce_bwd(rows, w, g),
                         tr.plain_tap_reduce_bwd(rows, w, g)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tap_reduce_cuda.launches,
            tap_reduce_bwd_cuda.launches) == before == (0, 0)
