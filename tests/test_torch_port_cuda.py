"""The CUDA cost-volume kernels (K1 forward, K2 backward) against their
plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import (cost_volume_bwd_cuda,
                                            cost_volume_cuda)
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (build_cost_volume,
                                                    plain_cost_volume,
                                                    plain_cost_volume_bwd)

pytestmark = pytest.mark.cuda

GEOMETRIES = {   # as tests/test_torch_port_cost_volume.py, plus a border case
    "translation": dict(tx=40.0, ty=12.0, dmin=430.0, dint=2.65),
    "absurd_baseline": dict(tx=900.0, ty=0.0, dmin=30.0, dint=8.0),
    "negative_depth": dict(tx=40.0, ty=12.0, dmin=-9.0, dint=2.65),
    "border": dict(tx=-12000.0, ty=300.0, dmin=430.0, dint=2.65),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(C, D, tx, ty, dmin, dint, B=2, V=3, H=20, W=36, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(B, V, H, W, C).astype(np.float32)
    proj = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32),
                   (B, V - 1, 1, 1))
    proj[..., 0, 3] = tx
    proj[..., 1, 3] = ty
    proj[1, :, :3, :3] += rng.randn(V - 1, 3, 3).astype(np.float32) * 0.01
    dv = ((dmin + dint * np.arange(D, dtype=np.float32))[None, :, None, None]
          * np.ones((B, D, H, W), np.float32))
    return (torch.from_numpy(a).cuda() for a in (feats, proj, dv))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_kernel_matches_plain(cuda, C, groups, geometry):
    feats, proj, dv = _scene(C, 8, **GEOMETRIES[geometry])
    before = cost_volume_cuda.launches
    got = build_cost_volume(feats, proj, dv, groups)
    assert cost_volume_cuda.launches == before + 1
    ref = plain_cost_volume(feats, proj, dv, groups)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    fb = feats.to(torch.bfloat16)
    got_b = cost_volume_cuda(fb, proj, dv, groups)
    ref_b = plain_cost_volume(fb.float(), proj, dv, groups)
    assert got_b.dtype == torch.bfloat16
    # within one bf16 ulp of the f32 result (8 significant bits)
    ulp = torch.ldexp(torch.ones_like(ref_b), torch.frexp(ref_b)[1] - 8)
    assert bool(((got_b.float() - ref_b).abs() <= ulp).all())


def bf16_ulp(x):
    """Spacing of bf16 numbers at x (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - 8)


# K2 adds the source views' shares with atomics, in an order that changes
# from run to run: f32 agrees with the plain backward to rounding (1e-5 at
# unit-scale inputs), and a bf16 result within 2 bf16 ulps of the plain f32
# backward of the same bf16 inputs, rounded, or within the f32 bound where
# cancellation leaves a value so small that the summation order moves it
# by more than 2 of its ulps.
BWD_TOL = 1e-5


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_bwd_kernel_matches_plain(cuda, C, groups, geometry):
    feats, proj, dv = _scene(C, 8, **GEOMETRIES[geometry])
    g = torch.Generator(device="cuda").manual_seed(C + groups)
    shape = (2, 8, 20, 36, C if groups == 1 else groups)
    go = torch.randn(shape, generator=g, device="cuda")
    before = cost_volume_bwd_cuda.launches
    got = cost_volume_bwd_cuda(feats, proj, dv, go, groups)
    assert cost_volume_bwd_cuda.launches == before + 1
    ref = plain_cost_volume_bwd(feats, proj, dv, go, groups)
    assert got.shape == feats.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    fb, gb = feats.to(torch.bfloat16), go.to(torch.bfloat16)
    got_b = cost_volume_bwd_cuda(fb, proj, dv, gb, groups)
    ref_b = plain_cost_volume_bwd(fb.float(), proj, dv, gb.float(), groups
                                  ).to(torch.bfloat16).float()
    assert got_b.dtype == torch.bfloat16
    err = (got_b.float() - ref_b).abs()
    assert bool((err <= 2 * bf16_ulp(ref_b) + BWD_TOL).all())


@pytest.mark.parametrize("groups", [1, 8])
def test_autograd_function_matches_plain_autograd(cuda, groups):
    feats, proj, dv = _scene(16, 8, **GEOMETRIES["translation"])
    g = torch.Generator(device="cuda").manual_seed(7)
    feats = feats.requires_grad_(True)
    launches = cost_volume_cuda.launches, cost_volume_bwd_cuda.launches
    out = build_cost_volume(feats, proj, dv, groups)
    go = torch.randn(out.shape, generator=g, device="cuda")
    got, = torch.autograd.grad(out, feats, go)
    assert (cost_volume_cuda.launches, cost_volume_bwd_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref, = torch.autograd.grad(plain_cost_volume(feats, proj, dv, groups),
                               feats, go)
    torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    # bf16 features: the gradient comes back in the features' dtype
    fb = feats.detach().to(torch.bfloat16).requires_grad_(True)
    out_b = build_cost_volume(fb, proj, dv, groups)
    gb, = torch.autograd.grad(out_b, fb, go.to(torch.bfloat16))
    assert out_b.dtype == gb.dtype == torch.bfloat16


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    go = torch.zeros(2, 8, 20, 36, 8, device="cuda")
    with pytest.raises(ValueError, match="grad_out"):
        cost_volume_bwd_cuda(feats, proj, dv, go.to(torch.bfloat16))
    with pytest.raises(ValueError, match="grad_out"):
        cost_volume_bwd_cuda(feats, proj, dv, go[..., :4].contiguous(),
                             groups=1)
    with pytest.raises(ValueError, match="contiguous"):
        cost_volume_bwd_cuda(feats, proj, dv, go.transpose(2, 3)
                             .contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="autograd"):
        cost_volume_cuda(feats.requires_grad_(True), proj, dv)


def test_kernel_rejects_what_it_does_not_take(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    with pytest.raises(ValueError, match="contiguous"):
        cost_volume_cuda(feats, proj, dv.transpose(2, 3).contiguous()
                         .transpose(2, 3))
    with pytest.raises(ValueError, match="C="):
        cost_volume_cuda(torch.cat([feats, feats[..., :4]], -1), proj, dv)
    with pytest.raises(ValueError, match="groups"):
        cost_volume_cuda(feats, proj, dv, groups=3)
    with pytest.raises(ValueError, match="proj_mats"):
        cost_volume_cuda(feats, proj.double(), dv)
