"""The plain versions of the probe kernels (TPU kernels #9-#13,
``casmvsnet_pl_tpu_torch/probes/``) against the TPU probes' own Pallas
kernels, run in Pallas interpret mode on the CPU.

The probe scripts run their sweeps when imported, and
``scripts/probe_epi2.py`` imports a function the JAX package no longer has,
so :func:`load_defs` takes only a script's import statements (skipping one
that fails) and its ``def``s, and a test sets the globals the kernels read
(``dtype``; ``H`` and ``W`` of ``probe_gather.py``). ``probe_epi5.py`` and
the modules it imports load whole. Small sizes: B=1, D=8, hw=256, C in
{8, 16}, tiles of 128. Bounds: 1e-5 abs and rel for the epilogues (the
sums run in other orders; ``var_kernel`` divides by 3 where #3 multiplies
by 1/3), 1e-4 for the whole patch view (``probe_epi5.py::run_check``'s
bound), bit-exact for the copies and gathers.
"""
import ast
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from casmvsnet_pl_tpu_torch import kernels
from casmvsnet_pl_tpu_torch.ops import quad_rows
from casmvsnet_pl_tpu_torch.probes import epi2, epi3, epi5, gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TOL = dict(rtol=1e-5, atol=1e-5)
B, D, HW, T = 1, 8, 256, 128


def load_script(name):
    """scripts/<name>.py imported whole, under its own name, so that the
    scripts that import it by that name find it."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(SCRIPTS, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def load_defs(name):
    """The import statements and ``def``s of scripts/<name>.py, without its
    top-level sweep."""
    path = os.path.join(SCRIPTS, name + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mod = types.ModuleType(name)
    mod.__file__ = path
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            try:
                exec(compile(ast.Module([node], []), path, "exec"),
                     mod.__dict__)
            except ImportError:
                continue
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            exec(compile(ast.Module([node], []), path, "exec"), mod.__dict__)
    return mod


kce = load_script("kernel_cost_epilogue")
pe2 = load_defs("probe_epi2")
pe3 = load_defs("probe_epi3")
pg = load_defs("probe_gather")
load_script("probe_patch")
load_script("probe_patch2")
pe5 = load_script("probe_epi5")


def epilogue_inputs(C, seed):
    """ref (B, HW, C), rows and ws of the two source views, f32, some
    weights zero (taps outside the image)."""
    rng = np.random.RandomState(seed)
    ref = rng.rand(B, HW, C).astype(np.float32)
    rows = rng.rand(B, 2, D, HW, 4 * C).astype(np.float32)
    ws = rng.rand(B, 2, D, HW, 4).astype(np.float32)
    ws[rng.rand(*ws.shape) < 0.2] = 0.0
    return ref, rows, ws


def views(a):
    """(B, S, ...) -> the tuple of S per-view JAX arrays."""
    return tuple(jnp.asarray(a[:, v]) for v in range(a.shape[1]))


@pytest.mark.parametrize("dblk", [1, 4, 8])
@pytest.mark.parametrize("C", [8, 16])
def test_variance_dblk_matches_probe(C, dblk):
    """#9: elementwise against the probe's ``variance_dblk`` (interpret
    mode, T=128) and against ``kernel_cost_epilogue.variance_epilogue``."""
    ref, rows, ws = epilogue_inputs(C, C + dblk)
    pe2.dtype = jnp.float32
    before = kernels.launch_counts()
    got = epi2.variance_dblk(*(torch.from_numpy(a) for a in (ref, rows, ws)),
                             dblk)
    assert kernels.launch_counts() == before
    assert got.shape == (B, D, HW, C) and got.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        probe = pe2.variance_dblk(jnp.asarray(ref), views(rows), views(ws),
                                  dblk, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(probe), **TOL)
    xla = kce.variance_epilogue(jnp.asarray(ref), views(rows), views(ws),
                                jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


@pytest.mark.parametrize("C", [8, 16])
def test_variance_v3_matches_probe(C):
    """#10: elementwise against ``variance_epilogue``, and its sum against
    the sum ``make_var(T)`` returns (interpret mode)."""
    ref, rows, ws = epilogue_inputs(C, 20 + C)
    pe3.dtype = jnp.float32
    got = epi3.variance_v3(*(torch.from_numpy(a) for a in (ref, rows, ws)))
    xla = kce.variance_epilogue(jnp.asarray(ref), views(rows), views(ws),
                                jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    with pltpu.force_tpu_interpret_mode():
        probe_sum = pe3.make_var(T)(jnp.asarray(ref), *views(rows),
                                    *views(ws))
    np.testing.assert_allclose(float(jnp.sum(jnp.asarray(got.numpy()))),
                               float(probe_sum), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 16])
def test_lane_prefix_copy_matches_probe(C, dtype):
    """#11: bit-exact against rows[..., :C] and, summed by the same JAX
    reduction, against the sum ``make_copy(T)`` returns."""
    rng = np.random.RandomState(30 + C)
    rows = jnp.asarray(rng.randn(B, D, HW, 4 * C).astype(np.float32),
                       getattr(jnp, dtype))
    trows = torch.from_numpy(np.array(rows.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = kernels.launch_counts()
    got = epi3.lane_prefix_copy(trows)
    assert kernels.launch_counts() == before
    assert got.dtype == trows.dtype and got.is_contiguous()
    assert torch.equal(got, trows[..., :C])
    pe3.dtype = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        probe_sum = pe3.make_copy(T)(rows)
    got_j = jnp.asarray(got.float().numpy()).astype(getattr(jnp, dtype))
    assert float(jnp.sum(got_j.astype(jnp.float32))) == float(probe_sum)


def transposed_inputs(Ch, seed, g=8):
    """rowsT (B, 1, 16 Ch, HW) f32 and fx, fy (B, 1, g, HW) in the patch,
    some samples invalid (fx = -9)."""
    rng = np.random.RandomState(seed)
    rowsT = rng.randn(B, 1, 16 * Ch, HW).astype(np.float32)
    fx = rng.uniform(0.0, 3.0, (B, 1, g, HW)).astype(np.float32)
    fy = rng.uniform(0.0, 3.0, (B, 1, g, HW)).astype(np.float32)
    fx[rng.rand(*fx.shape) < 0.1] = -9.0
    return rowsT, fx, fy


@pytest.mark.parametrize("Ch", [8, 16])
def test_patch_epilogue_t_matches_probe(Ch):
    """#12: against the probe's ``pallas_epilogue`` (interpret mode,
    T=128) and its ``tfma_epilogue``, through the (B, D, hw, C) layout."""
    rowsT, fx, fy = transposed_inputs(Ch, 40 + Ch)
    before = kernels.launch_counts()
    got = epi5.transposed_epilogue(*(torch.from_numpy(a)
                                     for a in (rowsT, fx, fy)))
    assert kernels.launch_counts() == before
    assert got.shape == (B, 8, HW, Ch) and got.dtype == torch.float32
    plain = epi5.plain_patch_epilogue_t(
        *(torch.from_numpy(a.reshape(B, -1, HW)) for a in (rowsT, fx, fy)))
    assert plain.shape == (B, 8, Ch, HW)
    j = [jnp.asarray(a) for a in (rowsT, fx, fy)]
    tfma = pe5.tfma_epilogue(*j, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(tfma), **TOL)
    with pltpu.force_tpu_interpret_mode():
        probe = pe5.pallas_epilogue(*j, 4, 4, T=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(probe), **TOL)


def test_patch_view_matches_probe():
    """#12's whole view at 32x64, D=8, g=8 (``run_check``'s inputs): the
    port's inputs equal the probe's, and its kernel, tfma and validfold
    views agree with the probe's ``make_view_fn("tfma")`` and
    ``patch_view(..., "validfold")`` within 1e-4."""
    jfeat, jproj, jdepths, H, W = pe5._setup(0, 8, 8, B=1, H0=32, W0=64)
    feat, proj, depths, H2, W2 = epi5.setup(0, 8, 8, batch=1, hw0=(32, 64))
    assert (H2, W2) == (H, W)
    np.testing.assert_array_equal(proj, np.asarray(jproj))
    np.testing.assert_array_equal(depths, np.asarray(jdepths))
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32)),
        np.asarray(jfeat.astype(jnp.float32)))
    jfeat = jfeat.astype(jnp.float32)
    want_tfma = np.asarray(pe5.make_view_fn("tfma", H, W, 4, 4, 8)(
        jfeat, jproj, jdepths))
    want_vf = np.asarray(pe5.patch_view(
        jax.vmap(lambda f: pe5._pack_patches(f, 4, 4))(jfeat), jproj,
        jdepths, H, W, 4, 4, 8, "validfold"))
    tf = [torch.from_numpy(np.array(a)) for a in (jfeat, jproj, jdepths)]
    for variant in ("kernel", "tfma", "validfold"):
        got = epi5.patch_view(*tf, H, W, 1, variant).numpy()
        np.testing.assert_allclose(got, want_tfma, rtol=0, atol=1e-4,
                                   err_msg=variant)
        np.testing.assert_allclose(got, want_vf, rtol=0, atol=1e-4,
                                   err_msg=variant)


def test_patch_table_matches_probe():
    """``pack_patches`` equals the probe scripts' ``_pack_patches``."""
    feat = np.random.RandomState(50).randn(2, 5, 7, 8).astype(np.float32)
    want = jax.vmap(lambda f: pe5._pack_patches(f, 4, 4))(jnp.asarray(feat))
    got = epi5.pack_patches(torch.from_numpy(feat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_and_lane_gathers_match_probe():
    """#13: the plain row gather and every PyTorch form of it, bit-exact
    against the probe's ``k_take``, ``k_tala``, ``k_onehot`` and
    ``k_dynslice`` (interpret mode), and the lane gather against
    ``k_take_lane``."""
    rng = np.random.RandomState(60)
    pg.H, pg.W = 8, 64                        # feat rows H * W
    feat = rng.rand(pg.H * pg.W, 128).astype(np.float32)
    idx = rng.randint(0, pg.H * pg.W, (256,)).astype(np.int32)
    featT = rng.rand(8, 1024).astype(np.float32)
    idx_lane = rng.randint(0, 1024, (128,)).astype(np.int32)
    tfeat, tidx = torch.from_numpy(feat), torch.from_numpy(idx).long()
    before = kernels.launch_counts()
    got = gather.row_gather(tfeat, tidx)
    forms = gather.check_forms(tfeat, tidx)
    got_lane = gather.lane_gather(torch.from_numpy(featT),
                                  torch.from_numpy(idx_lane).long())
    assert kernels.launch_counts() == before
    with pltpu.force_tpu_interpret_mode():
        for name in ("k_take", "k_tala", "k_onehot", "k_dynslice"):
            probe = pl.pallas_call(getattr(pg, name), out_shape=jax.
                                   ShapeDtypeStruct((256, 128), jnp.float32))(
                feat, idx)
            np.testing.assert_array_equal(got.numpy(), np.asarray(probe),
                                          err_msg=name)
            np.testing.assert_array_equal(forms[name].numpy(),
                                          np.asarray(probe), err_msg=name)
        probe_lane = pl.pallas_call(pg.k_take_lane, out_shape=jax.
                                    ShapeDtypeStruct((8, 128), jnp.float32))(
            featT, idx_lane)
    np.testing.assert_array_equal(got_lane.numpy(), np.asarray(probe_lane))


def test_probe_inputs_are_the_scripts():
    """The probes' inputs are drawn as the scripts draw them: the gather
    probe's arrays, epi3's rows, weights and ref (RandomState(0), in that
    order, at a small shape) and epi2's projections and depths."""
    feat, idx, featT, idx_lane = gather.probe_inputs("cpu")
    np.testing.assert_array_equal(
        feat.numpy(), np.random.RandomState(0).rand(8192, 128)
        .astype(np.float32))
    np.testing.assert_array_equal(
        idx.numpy(), np.random.RandomState(1).randint(0, 8192, (256,)))
    assert featT.shape == (8, 1024) and idx_lane.shape == (128,)

    ref, rows, ws = epi3.inputs("cpu", (2, 3, 16, 8))
    rng = np.random.RandomState(0)
    want_rows = [rng.randn(2, 3, 16, 32).astype(np.float32)
                 for _ in range(2)]
    want_ws = [rng.rand(2, 3, 16, 4).astype(np.float32) for _ in range(2)]
    for v in range(2):
        np.testing.assert_array_equal(rows[:, v].numpy(), want_rows[v])
        np.testing.assert_array_equal(ws[:, v].numpy(), want_ws[v])
    np.testing.assert_array_equal(
        ref.numpy(), rng.randn(2, 16, 8).astype(np.float32))

    feats, proj, dv = epi2.level_inputs(np.random.RandomState(0), 4, 6, 5, 8,
                                        "cpu")
    assert feats.shape == (2, 3, 6, 5, 8)
    assert proj.shape == (2, 2, 3, 4) and bool((proj[..., 0, 3] == 3).all())
    np.testing.assert_allclose(dv[0, :, 0, 0].numpy(),
                               425.0 + 2.65 * np.arange(4), rtol=1e-6)
    ref, rows, ws, _ = quad_rows(feats, proj, dv)
    got = epi2.variance_dblk(ref, rows, ws, 2)
    want = kce.variance_epilogue(jnp.asarray(ref.numpy()),
                                 views(rows.numpy()), views(ws.numpy()),
                                 jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
