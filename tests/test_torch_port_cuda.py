"""The CUDA cost-volume kernel against its plain version, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (build_cost_volume,
                                                    plain_cost_volume)

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


def test_kernel_refuses_autograd(cuda):
    feats, proj, dv = _scene(8, 8, **GEOMETRIES["translation"])
    feats.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training"):
        cost_volume_cuda(feats, proj, dv)
    with torch.no_grad():
        cost_volume_cuda(feats, proj, dv)


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
