"""The plain versions of the quad configuration's cost epilogue kernels
(TPU kernels #3-#6) against the JAX package's.

The reference is ``scripts/kernel_cost_epilogue.py``, imported by path. On
the CPU its ``_use_kernel`` is False, so ``variance_epilogue`` and
``groupwise_epilogue`` and their custom VJPs run the XLA formulations
(``_var_xla``, ``_var_bwd_xla``, ``_gw_xla``, ``_gw_bwd_xla``), as
``scripts/probe_epilogue.py`` holds the Pallas kernels against them on the
TPU. The port takes the source views stacked into one tensor where the TPU
functions take tuples. Bound 1e-5, abs and rel: the two sum the taps and
the groups in other orders.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import (groupwise_epilogue_bwd_cuda,
                                            groupwise_epilogue_cuda,
                                            variance_epilogue_bwd_cuda,
                                            variance_epilogue_cuda)
from casmvsnet_pl_tpu_torch.ops import cost_epilogue as ce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "kernel_cost_epilogue", os.path.join(REPO, "scripts",
                                         "kernel_cost_epilogue.py"))
kce = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kce)

TOL = dict(rtol=1e-5, atol=1e-5)


def inputs(rng, C, V, B=2, D=3, hw=37):
    """ref (B, hw, C), rows (B, S, D, hw, 4C), ws (B, S, D, hw, 4) with
    some zero weights (taps outside the image), S = V-1. hw = 37 is no
    multiple of the TPU kernels' tile."""
    S = V - 1
    ref = rng.rand(B, hw, C).astype(np.float32)
    rows = rng.rand(B, S, D, hw, 4 * C).astype(np.float32)
    ws = rng.rand(B, S, D, hw, 4).astype(np.float32)
    ws[rng.rand(B, S, D, hw, 4) < 0.2] = 0.0
    return ref, rows, ws


def _jax(fn, ref, rows, ws, groups, grad):
    """JAX forward and VJP of the epilogue, views as tuples."""
    S = rows.shape[1]
    rt = tuple(jnp.asarray(rows[:, v]) for v in range(S))
    wt = tuple(jnp.asarray(ws[:, v]) for v in range(S))
    if groups == 1:
        f = lambda r, rs, w: fn(r, rs, w, jnp.float32)  # noqa: E731
    else:
        f = lambda r, rs, w: fn(r, rs, w, groups, jnp.float32)  # noqa: E731
    out, vjp = jax.vjp(f, jnp.asarray(ref), rt, wt)
    d_ref, d_rows, d_ws = vjp(jnp.asarray(grad))
    return (np.asarray(out), np.asarray(d_ref),
            np.stack([np.asarray(d) for d in d_rows], 1),
            np.stack([np.asarray(d) for d in d_ws], 1))


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("V", [2, 3])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_epilogue_matches_jax(C, V, groups):
    rng = np.random.RandomState(C + 10 * V + groups)
    ref, rows, ws = inputs(rng, C, V)
    B, S, D, hw, _ = rows.shape
    grad = rng.randn(B, D, hw, C if groups == 1 else groups).astype(
        np.float32)
    jfn = kce.variance_epilogue if groups == 1 else kce.groupwise_epilogue
    want = _jax(jfn, ref, rows, ws, groups, grad)

    tr, trows, tws, tg = (torch.from_numpy(a) for a in (ref, rows, ws, grad))
    if groups == 1:
        out = ce.plain_variance_epilogue(tr, trows, tws)
        grads = ce.plain_variance_epilogue_bwd(tr, trows, tws, tg)
    else:
        out = ce.plain_groupwise_epilogue(tr, trows, tws, groups)
        grads = ce.plain_groupwise_epilogue_bwd(tr, trows, tws, tg, groups)
    assert out.shape == want[0].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want[0], **TOL)
    for name, got, w in zip(("d ref", "d rows", "d ws"), grads, want[1:]):
        assert got.shape == w.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_plain_epilogue_bf16_is_rounded_f32(groups):
    """bf16 rows and ref: the sums run in f32 over the bf16 values and the
    result is rounded once; d rows comes back in bf16, d ref and d ws in
    f32."""
    rng = np.random.RandomState(40 + groups)
    ref, rows, ws = (torch.from_numpy(a) for a in inputs(rng, 16, 3))
    rb, rowsb = ref.to(torch.bfloat16), rows.to(torch.bfloat16)
    grad = torch.from_numpy(rng.randn(2, 3, 37, 16 if groups == 1 else groups)
                            .astype(np.float32)).to(torch.bfloat16)
    if groups == 1:
        fwd = ce.plain_variance_epilogue
        bwd = ce.plain_variance_epilogue_bwd
    else:
        fwd = lambda *a: ce.plain_groupwise_epilogue(*a, groups)  # noqa: E731
        bwd = lambda *a: ce.plain_groupwise_epilogue_bwd(  # noqa: E731
            *a, groups)
    got = fwd(rb, rowsb, ws)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got, fwd(rb.float(), rowsb.float(), ws).to(torch.bfloat16),
        rtol=0, atol=0)
    d = bwd(rb, rowsb, ws, grad)
    want = bwd(rb.float(), rowsb.float(), ws, grad.float())
    assert [t.dtype for t in d] == [torch.float32, torch.bfloat16,
                                    torch.float32]
    torch.testing.assert_close(d[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(d[1], want[1].to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(d[2], want[2], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(50)
    ref, rows, ws = (torch.from_numpy(a) for a in inputs(rng, 8, 3))
    grad = torch.from_numpy(rng.randn(2, 3, 37, 8).astype(np.float32))
    kernels = (variance_epilogue_cuda, groupwise_epilogue_cuda,
               variance_epilogue_bwd_cuda, groupwise_epilogue_bwd_cuda)
    before = [k.launches for k in kernels]
    torch.testing.assert_close(ce.variance_epilogue(ref, rows, ws),
                               ce.plain_variance_epilogue(ref, rows, ws),
                               rtol=0, atol=0)
    torch.testing.assert_close(ce.groupwise_epilogue(ref, rows, ws, 2),
                               ce.plain_groupwise_epilogue(ref, rows, ws, 2),
                               rtol=0, atol=0)
    for got, want in zip(ce.variance_epilogue_bwd(ref, rows, ws, grad),
                         ce.plain_variance_epilogue_bwd(ref, rows, ws, grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    g2 = grad[..., :2].contiguous()
    for got, want in zip(ce.groupwise_epilogue_bwd(ref, rows, ws, g2, 2),
                         ce.plain_groupwise_epilogue_bwd(ref, rows, ws, g2,
                                                         2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [k.launches for k in kernels] == before == [0, 0, 0, 0]
