"""TransMVSNet on the port's eval path, on the CPU: the model against the
benchmark's plain reference (``perfbench/reference/transmvsnet.py``) in
float32, the deformable conv's plain version against the reference's
gathers and against ``F.conv2d``, LoFTR's linear attention against the same
kernel attention computed quadratically, the one-group correlation against
the reference's, the kind of volume through ``build_cost_volume``, the
spans, and the CLIs that build or refuse the model.

The tests marked ``cuda`` hold the deformable conv's kernel
(``csrc/deform_conv.cu``) and K1's one-group correlation against their
plain versions; they skip (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_transmvsnet.py --noconftest -m cuda
"""
import os
import sys

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import convert_ckpt_torch  # noqa: E402
import eval_torch  # noqa: E402
import train_torch  # noqa: E402
from casmvsnet_pl_tpu_torch.entry import entry  # noqa: E402
from casmvsnet_pl_tpu_torch.kernels.cost_volume import (  # noqa: E402
    cost_volume_bwd_cuda, volume_kind)
from casmvsnet_pl_tpu_torch.models import (TransMVSNet,  # noqa: E402
                                           build_model)
from casmvsnet_pl_tpu_torch.models.fmt import (linear_attention,  # noqa: E402
                                               sine_encoding)
from casmvsnet_pl_tpu_torch.ops.deform_conv import (  # noqa: E402
    deform_conv, plain_deform_conv)
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (  # noqa: E402
    build_cost_volume, plain_cost_volume)
from casmvsnet_pl_tpu_torch.opt import get_opts  # noqa: E402
from casmvsnet_pl_tpu_torch.utils.profiling import (RECORDER,  # noqa: E402
                                                    span_summary)
from perfbench import program, scenes  # noqa: E402
from perfbench.harness import architecture, load_json  # noqa: E402
from perfbench.reference import transmvsnet as ref_tm  # noqa: E402
from perfbench.reference.model import float32_exact  # noqa: E402

CFG = load_json("configs", "transmvsnet.json")
WH = (128, 96)                 # 3 views: the 1/4 level is 32 x 24
PROB_TOL = 1e-4
TIE = 1e-3


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


def _models(seed: int):
    """(reference, port), float32 on the CPU, the seed's weights."""
    arch = architecture(CFG)
    weights = program.draw_weights(CFG, seed, "cpu")
    ref = arch.reference(CFG)
    ref.load_state_dict(weights, strict=True)
    port = arch.port_model(CFG, weights, "cpu", torch.float32)
    return ref.eval(), port.eval()


def _port_run(port, batch):
    """The port's outputs and the probability volume of each level
    (captured where the model turns it into depth and confidence)."""
    probs = {}
    depth_and_confidence = port.depth_and_confidence

    def capture(prob, depth_values):
        probs[prob.shape[1]] = prob
        return depth_and_confidence(prob, depth_values)
    port.depth_and_confidence = capture
    try:
        with torch.no_grad():
            out = port(batch["imgs"], batch["proj_mats"],
                       batch["init_depth_min"], batch["depth_interval"])
    finally:
        del port.depth_and_confidence
    return out, probs


@pytest.mark.parametrize("seed", [3_000_000_011, 5])
def test_the_port_matches_the_reference_in_float32(seed, threads):
    """Every level's probability volume to 1e-4; the depth wherever the top
    two probabilities differ by more than 1e-3 (a near tie may pick either
    hypothesis); the confidences."""
    ref, port = _models(seed)
    batch = scenes.make_batch(seed, [0], WH, 3, 100.0, CFG, "cpu")
    with torch.no_grad(), float32_exact():
        want = ref(batch["imgs"], batch["proj_mats"],
                   batch["init_depth_min"], batch["depth_interval"])
        got, probs = _port_run(port, batch)
    for l in range(3):
        prob = want[f"prob_{l}"]
        assert (probs[prob.shape[1]] - prob).abs().max() <= PROB_TOL, l
        top2 = prob.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > TIE
        assert clear.float().mean() > 0.5, l
        d_got, d_want = got[f"depth_{l}"], want[f"depth_{l}"]
        assert torch.equal(d_got[clear], d_want[clear]), l
        assert (got[f"confidence_{l}"] - want[f"confidence_{l}"]).abs().max() \
            <= PROB_TOL, l


@pytest.mark.parametrize("C", [8, 16, 32])
def test_the_plain_deformable_conv_matches_the_reference_gathers(C):
    g = torch.Generator().manual_seed(C)
    x = torch.randn((2, C, 13, 17), generator=g)
    om = torch.randn((2, 27, 13, 17), generator=g) * 3.0
    w = torch.randn((C, C, 3, 3), generator=g)
    dcn = ref_tm.DeformConv(C)
    with torch.no_grad():
        dcn.weight.copy_(w)
        dcn.conv_offset_mask.forward = lambda t: om
        want = dcn(x)
    got = plain_deform_conv(x, om, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the op is the plain version
    assert torch.equal(deform_conv(x, om, w), got)


@pytest.mark.parametrize("C", [8, 16, 32])
def test_zero_offsets_and_unit_masks_make_a_plain_conv(C):
    g = torch.Generator().manual_seed(100 + C)
    x = torch.randn((2, C, 11, 9), generator=g)
    w = torch.randn((C, C, 3, 3), generator=g)
    om = torch.zeros((2, 27, 11, 9))
    om[:, 18:] = 1e4                   # sigmoid: 1
    torch.testing.assert_close(plain_deform_conv(x, om, w),
                               F.conv2d(x, w, padding=1), rtol=1e-5,
                               atol=1e-4)


def test_an_offset_of_one_pixel_shifts_the_taps():
    """Every tap moved by (0, +1) is the plain conv of the image shifted
    left by a column (zero in the last column), away from the first output
    column (whose left taps read the image's column 0, not padding)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 8, 7, 10), generator=g)
    w = torch.randn((8, 8, 3, 3), generator=g)
    om = torch.zeros((1, 27, 7, 10))
    om[:, 1:18:2] = 1.0
    om[:, 18:] = 1e4
    shifted = F.pad(x[..., 1:], (0, 1))
    torch.testing.assert_close(plain_deform_conv(x, om, w)[..., 1:],
                               F.conv2d(shifted, w, padding=1)[..., 1:],
                               rtol=1e-5, atol=1e-4)


def _quadratic_attention(q, k, v, eps=1e-6):
    """phi(Q) phi(K)^T V / (phi(Q) sum_s phi(K_s) + eps) as an L x S
    matrix per head, phi = elu + 1."""
    phi_q, phi_k = F.elu(q) + 1, F.elu(k) + 1
    scores = torch.einsum("nlhd,nshd->nhls", phi_q, phi_k)
    num = torch.einsum("nhls,nshv->nlhv", scores, v)
    den = scores.sum(-1).permute(0, 2, 1)[..., None]
    return num / (den + eps)


@pytest.mark.parametrize("repeat", [1, 4])
def test_linear_attention_is_the_kernel_attention(repeat):
    """Self (one source a query batch) and cross (each source serving
    ``repeat`` query batches, the source views of one scene)."""
    g = torch.Generator().manual_seed(repeat)
    q = torch.randn((2 * repeat, 50, 8, 4), generator=g, dtype=torch.float64)
    k = torch.randn((2, 37, 8, 4), generator=g, dtype=torch.float64)
    v = torch.randn((2, 37, 8, 4), generator=g, dtype=torch.float64)
    got = linear_attention(q, k, v)
    want = _quadratic_attention(q, k.repeat_interleave(repeat, 0),
                                v.repeat_interleave(repeat, 0))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_the_sine_encoding_is_loftrs():
    pe = ref_tm.sine_position(32, 24, 40, "cpu")          # (d, h, w)
    torch.testing.assert_close(sine_encoding(32, 24, 40),
                               pe.permute(1, 2, 0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("C", [8, 32])
def test_the_one_group_correlation_is_the_references(C):
    g = torch.Generator().manual_seed(C)
    B, V, H, W, D = 2, 4, 12, 20, 6
    feats = torch.rand((B, V, H, W, C), generator=g)
    proj = scenes.proj_mats(V, 30.0, 1, "cpu")[:, 0][None].repeat(
        B, 1, 1, 1)
    depth = 400.0 + 7.0 * torch.rand((B, D, H, W), generator=g)
    got = plain_cost_volume(feats, proj, depth, 1, kind="groupwise")
    assert got.shape == (B, D, H, W, 1)
    want = ref_tm.correlation(feats.permute(0, 1, 4, 2, 3), proj, depth,
                              chunk=4)                    # (B, 1, D, H, W)
    torch.testing.assert_close(got[..., 0], want[:, 0], rtol=1e-5,
                               atol=1e-6)
    # by kind, not by G: G = 1 alone is still the variance
    assert plain_cost_volume(feats, proj, depth, 1).shape[-1] == C
    assert torch.equal(build_cost_volume(feats, proj, depth, 1,
                                         kind="groupwise"), got)


def test_the_kind_of_volume():
    assert volume_kind(None, 1) == "variance"
    assert volume_kind(None, 8) == "groupwise"
    assert volume_kind("groupwise", 1) == "groupwise"
    with pytest.raises(ValueError):
        volume_kind("variance", 4)
    with pytest.raises(ValueError):
        volume_kind("sum", 1)
    feats = torch.rand((1, 3, 8, 8, 8))
    proj = torch.zeros((1, 2, 3, 4))
    depth = torch.ones((1, 8, 8, 8))
    with pytest.raises(ValueError, match="quad"):
        build_cost_volume(feats, proj, depth, 1, sampling="quad",
                          kind="groupwise")
    # K2 has no one-group correlation: refused before any launch
    with pytest.raises(NotImplementedError, match="TransMVSNet"):
        cost_volume_bwd_cuda(feats, proj, depth, depth[..., None], 1,
                             "groupwise")


def test_the_forward_records_the_arf_and_the_fmt_inside_the_features():
    fn, args = entry("cpu", img_wh=(64, 64), arch="transmvsnet")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn(*args)
    count = span_summary()
    assert count["cascade.arf"]["count"] == 3
    assert count["cascade.fmt"]["count"] == 1
    assert count["fmt.block"]["count"] == 4
    assert count["host_sync"]["count"] == 2
    arf = [s for s in RECORDER.spans if s.name == "cascade.arf"]
    assert [s.attrs["level"] for s in arf] == [0, 1, 2]
    (fmt,) = [s for s in RECORDER.spans if s.name == "cascade.fmt"]
    assert fmt.attrs["tokens"] == 3 * 16 * 16
    for s in arf + [fmt]:
        assert s.parent.name == "cascade.features"
    blocks = [s for s in RECORDER.spans if s.name == "fmt.block"]
    assert all(s.parent is fmt for s in blocks)


def test_build_model_by_arch():
    model = build_model("transmvsnet")
    assert isinstance(model, TransMVSNet)
    assert all(getattr(model, f"cost_reg_{l}").conv0.conv.in_channels == 1
               for l in range(3))
    with pytest.raises(ValueError, match="one-group"):
        build_model("transmvsnet", num_groups=8)
    with pytest.raises(ValueError, match="unknown arch"):
        build_model("mvsnet")


def test_eval_torch_builds_transmvsnet(threads):
    args = eval_torch.get_opts(["--cpu", "--arch", "transmvsnet",
                                "--precision", "f32"])
    predict = eval_torch.build_predictor(args)
    assert isinstance(predict.model, TransMVSNet)
    assert isinstance(eval_torch.build_predictor(eval_torch.get_opts(
        ["--cpu"])).model, eval_torch.CascadeMVSNet)
    batch = scenes.make_batch(1, [0], (64, 64), 3, 60.0, CFG, "cpu")
    depth, conf = predict(batch["imgs"], batch["proj_mats"], 425.0, 2.65)
    assert depth.shape == (1, 64, 64) and conf.shape == (1, 16, 16)
    assert torch.isfinite(depth).all()
    assert ((conf > 0) & (conf <= 1)).all()


def test_train_torch_refuses_transmvsnet(tmp_path):
    opts = get_opts(["--cpu", "--arch", "transmvsnet", "--root_dir",
                     str(tmp_path)])
    with pytest.raises(SystemExit, match="cannot be trained"):
        train_torch.main(opts)
    assert get_opts([]).arch == "casmvsnet"


def test_convert_ckpt_torch_refuses_transmvsnet(tmp_path):
    with pytest.raises(SystemExit, match="no converter"):
        convert_ckpt_torch.main([str(tmp_path / "a.ckpt"),
                                 str(tmp_path / "b.ckpt"), "--arch",
                                 "transmvsnet"])


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bf16_ulp(x):
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("C,shape", [(8, (3, 37, 29)), (16, (2, 20, 33)),
                                     (32, (5, 24, 31))])
def test_the_deformable_kernel_matches_its_plain_version(cuda, C, shape):
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_cuda
    N, H, W = shape
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn((N, H, W, C), generator=g, device=cuda).permute(0, 3, 1, 2)
    om = (torch.randn((N, H, W, 27), generator=g, device=cuda) * 2.0
          ).permute(0, 3, 1, 2)
    w = torch.randn((C, C, 3, 3), generator=g, device=cuda) * (2 / 9 / C) ** .5
    terms = plain_deform_conv(x.abs(), om, w.abs())
    err = (deform_conv_cuda(x, om, w) - plain_deform_conv(x, om, w)).abs()
    assert (err <= 1e-5 * terms).all()
    xb, ob, wb = x.bfloat16(), om.bfloat16(), w.bfloat16()
    want = plain_deform_conv(xb.float(), ob.float(), wb.float())
    tol = torch.maximum(1e-5 * plain_deform_conv(xb.float().abs(), ob.float(),
                                                 wb.float().abs()),
                        _bf16_ulp(want))
    got = deform_conv_cuda(xb, ob, wb)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert ((got.float() - want).abs() <= tol).all()


@pytest.mark.cuda
def test_k1_one_group_correlation_matches_its_plain_version(cuda):
    from casmvsnet_pl_tpu_torch.kernels import cost_volume_cuda
    g = torch.Generator(device=cuda).manual_seed(0)
    for C in (8, 16, 32):
        feats = torch.rand((1, 5, 24, 40, C), generator=g, device=cuda)
        proj = scenes.proj_mats(5, 40.0, 1, cuda)[:, 0][None].contiguous()
        depth = 400.0 + 20.0 * torch.rand((1, 16, 24, 40), generator=g,
                                          device=cuda)
        got = cost_volume_cuda(feats, proj, depth, 1, "groupwise")
        want = plain_cost_volume(feats, proj, depth, 1, "groupwise")
        assert got.shape == (1, 16, 24, 40, 1)
        assert torch.equal(got, want), C
