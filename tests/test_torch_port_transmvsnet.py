"""TransMVSNet on the port's eval path, on the CPU: the model against the
benchmark's plain reference (``perfbench/reference/transmvsnet.py``) in
float32, the deformable conv's plain version against the reference's
gathers and against ``F.conv2d``, LoFTR's linear attention against the same
kernel attention computed quadratically, the one-group correlation against
the reference's, the kind of volume through ``build_cost_volume``, the
spans, and the CLIs that build or refuse the model.

The tests marked ``cuda`` hold the deformable conv's kernels
(``csrc/deform_conv.cu``, the forward, and ``csrc/deform_conv_bwd.cu``, the
backward, against the plain version's autograd), K1's and K2's one-group
correlation against their plain versions, and a training step's launches;
they skip (inside the ``cuda`` fixture, never at collection) where there
is no CUDA device. On a
machine with one:

    python -m pytest tests/test_torch_port_transmvsnet.py --noconftest -m cuda
"""
import math
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
from casmvsnet_pl_tpu_torch.data import (DTUDataset,  # noqa: E402
                                         write_dtu_tree)
from casmvsnet_pl_tpu_torch.entry import entry  # noqa: E402
from casmvsnet_pl_tpu_torch.kernels.cost_volume import (  # noqa: E402
    cost_volume_bwd_cuda, volume_kind)
from casmvsnet_pl_tpu_torch.models import (TransMVSNet,  # noqa: E402
                                           build_model)
from casmvsnet_pl_tpu_torch.models.fmt import sine_encoding  # noqa: E402
from casmvsnet_pl_tpu_torch.ops.deform_conv import (  # noqa: E402
    deform_conv, plain_deform_conv)
from casmvsnet_pl_tpu_torch.ops.fmt_layer import linear_attention  # noqa: E402
from casmvsnet_pl_tpu_torch.ops.plane_sweep import (  # noqa: E402
    build_cost_volume, plain_cost_volume, plain_cost_volume_bwd)
from casmvsnet_pl_tpu_torch.opt import get_opts  # noqa: E402
from casmvsnet_pl_tpu_torch.utils import load_checkpoint  # noqa: E402
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
    # K2 takes the one-group correlation (TransMVSNet's training): its only
    # refusal here is the CPU tensors
    with pytest.raises(ValueError, match="CUDA tensors"):
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


class _TinyDTU(DTUDataset):
    """The tree of :func:`test_train_torch_refuses_transmvsnet`."""
    NATIVE_WH = (128, 128)
    DEPTH_CROP = ((16, 48), (16, 48))
    N_CAMS = 3
    LISTS_DIR = None


def test_train_torch_refuses_transmvsnet(tmp_path, monkeypatch, threads):
    """``train_torch.py --arch transmvsnet``, refused until TransMVSNet's
    training was ported, now trains: one epoch (21 samples, 3 steps) on a
    synthetic tree, on the CPU, through ``MVSTrainer`` with the focal loss,
    and its checkpoint holds TransMVSNet's parameters."""
    root = str(tmp_path / "dtu")
    write_dtu_tree(root, scans=("synth1", "synth2"), n_cams=3,
                   img_wh=(32, 32), native_wh=(128, 128), focal=50.0,
                   depth_crop=_TinyDTU.DEPTH_CROP)
    lists = os.path.join(root, "lists")
    os.makedirs(lists)
    for split, scan in (("train", "synth1"), ("val", "synth2")):
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write(scan + "\n")
    monkeypatch.setattr(_TinyDTU, "LISTS_DIR", lists)
    monkeypatch.chdir(tmp_path)
    opts = get_opts(["--cpu", "--arch", "transmvsnet", "--root_dir", root,
                     "--n_depths", "8", "8", "8", "--batch_size", "7",
                     "--optimizer", "adam", "--precision", "f32",
                     "--num_workers", "1", "--num_epochs", "1",
                     "--exp_name", "tm"])
    trainer, state = train_torch.main(opts, _TinyDTU, time_steps=True)
    assert isinstance(state.model, TransMVSNet) and state.step == 3
    assert all(math.isfinite(t["loss"]) and t["loss"] > 0
               for t in trainer.step_times)
    assert math.isfinite(trainer.epoch_metrics[0]["val/loss"])
    ckpt = load_checkpoint(os.path.join("ckpts", "tm", "last.ckpt"))
    assert "arf.0.dcn0.weight" in ckpt["params"]
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


def _plain_grads(x, om, w, gy):
    """The plain version's float32 gradients of (x, offsets and masks,
    weight) for the output gradient gy."""
    leaves = [t.detach().float().requires_grad_() for t in (x, om, w)]
    return torch.autograd.grad(plain_deform_conv(*leaves), leaves,
                               gy.float())


def _bwd_inputs(cuda, C, shape, seed, offset_scale=2.0):
    """x, offsets and masks (offsets times ``offset_scale``, masks N(0, 2)),
    weight and output gradient, channels_last, f32."""
    N, H, W = shape
    g = torch.Generator(device=cuda).manual_seed(seed)

    def nhwc(c, scale=1.0):
        return (torch.randn((N, H, W, c), generator=g, device=cuda)
                * scale).permute(0, 3, 1, 2)
    x, om, gy = nhwc(C), nhwc(27, 2.0), nhwc(C)
    om[:, :18] *= offset_scale / 2.0
    w = torch.randn((C, C, 3, 3), generator=g, device=cuda) * (2 / 9 / C) ** .5
    return x, om, w, gy


def _check_bwd_kernel(x, om, w, gy):
    """The kernel's three gradients against plain autograd: f32 within 1e-4
    of each gradient's largest magnitude (the two sum in different orders,
    the input's by atomics); bf16 within two bf16 ulps of the f32 plain
    gradients of the same bf16 values, and that bound."""
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_bwd_cuda
    before = deform_conv_bwd_cuda.launches
    got = deform_conv_bwd_cuda(x, om, w, gy)
    assert deform_conv_bwd_cuda.launches == before + 1
    for a, b, like in zip(got, _plain_grads(x, om, w, gy), (x, om, w)):
        assert a.shape == like.shape and a.dtype == torch.float32
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    assert got[1].is_contiguous(memory_format=torch.channels_last)
    xb, ob, wb, gb = (t.bfloat16() for t in (x, om, w, gy))
    got = deform_conv_bwd_cuda(xb, ob, wb, gb)
    for a, b in zip(got, _plain_grads(xb, ob, wb, gb)):
        assert a.dtype == torch.bfloat16
        tol = 2 * _bf16_ulp(b) + 1e-4 * b.abs().max()
        assert ((a.float() - b).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C,shape", [(8, (3, 37, 29)), (16, (2, 20, 33)),
                                     (32, (5, 24, 31))])
def test_the_deformable_backward_kernel_matches_plain_autograd(cuda, C,
                                                               shape):
    """One launch gives the three gradients, held to plain autograd as
    ``_check_bwd_kernel`` says."""
    _check_bwd_kernel(*_bwd_inputs(cuda, C, shape, 10 + C))


# the binned scatter's cases, each at every C: offsets far beyond any window
# (std 20 px, many taps outside the image: the spill path), zero offsets
# (nothing spills), and ragged shapes that no tile divides, N >= 3 (windows
# meet the images' edges and each other's images)
BIN_CASES = {"far": ((3, 37, 29), 20.0), "zero": ((3, 24, 32), 0.0),
             "ragged": ((4, 37, 29), 2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BIN_CASES))
@pytest.mark.parametrize("C", (8, 16, 32))
def test_the_deformable_backward_kernel_bins_and_spills(cuda, C, case):
    """The binned scatter against plain autograd (as the test above), and
    its counters: every share counted, none spilled at zero offsets, some
    at far ones."""
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_bwd_cuda
    shape, scale = BIN_CASES[case]
    x, om, w, gy = _bwd_inputs(cuda, C, shape, 20 + C, scale)
    deform_conv_bwd_cuda.reset_spill_counts()
    _check_bwd_kernel(x, om, w, gy)
    spilled, shares, adds = deform_conv_bwd_cuda.spill_counts()
    N, H, W = shape
    assert 0 < shares <= 2 * 36 * N * H * W and adds > 0
    if case == "zero":
        # each sample sits on a pixel next to its own: its 2 x 2 block of
        # taps lies inside every window (a halo of 2 or more)
        assert spilled == 0
    elif case == "far":
        assert spilled > 0.1 * shares
    else:
        assert spilled < shares


@pytest.mark.cuda
@pytest.mark.parametrize("C", (8, 16, 32))
def test_the_deformable_backward_kernel_repeats(cuda, C):
    """Two launches on the same inputs agree within the tolerance the
    kernel is held to against plain autograd (atomics add in an order that
    changes from run to run): f32 within 1e-4 of each gradient's largest
    magnitude, bf16 within two bf16 ulps and that bound."""
    from casmvsnet_pl_tpu_torch.kernels import deform_conv_bwd_cuda
    x, om, w, gy = _bwd_inputs(cuda, C, (3, 37, 29), 30 + C)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (x, om, w, gy)]
        first = deform_conv_bwd_cuda(*args)
        again = deform_conv_bwd_cuda(*args)
        for a, b in zip(first, again):
            a, b = a.float(), b.float()
            tol = 1e-4 * a.abs().max()
            if dtype == torch.bfloat16:
                tol = tol + 2 * _bf16_ulp(a)
            assert ((a - b).abs() <= tol).all()


@pytest.mark.cuda
def test_the_deformable_conv_trains_through_its_kernels(cuda):
    """Under bf16 autocast, float32 leaves: one forward and one backward
    launch, the gradients within two bf16 ulps (and 1e-3 of the largest)
    of the plain version's on the same bf16 values, and the arf.backward
    span; without a gradient the forward keeps nothing and the backward
    kernel never runs."""
    from casmvsnet_pl_tpu_torch.kernels import (deform_conv_bwd_cuda,
                                                deform_conv_cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 16, 21, 19), generator=g, device=cuda)
    om = torch.randn((2, 27, 21, 19), generator=g, device=cuda)
    w = torch.randn((16, 16, 3, 3), generator=g, device=cuda) * 0.1
    gy = torch.randn((2, 16, 21, 19), generator=g, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, om, w)]
    launches = deform_conv_cuda.launches, deform_conv_bwd_cuda.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = deform_conv(*leaves, level=1)
        assert y.dtype == torch.bfloat16
        got = torch.autograd.grad(y, leaves, gy.bfloat16())
    assert (deform_conv_cuda.launches, deform_conv_bwd_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    (bwd,) = [s for s in RECORDER.spans if s.name == "arf.backward"]
    assert bwd.attrs["level"] == 1
    want = _plain_grads(x.bfloat16(), om.bfloat16(), w.bfloat16(),
                        gy.bfloat16())
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        tol = 2 * _bf16_ulp(b) + 1e-3 * b.abs().max()
        assert ((a - b).abs() <= tol).all()
    with torch.inference_mode():
        out = deform_conv(x.bfloat16(), om.bfloat16(), w.bfloat16())
    assert out.grad_fn is None
    assert deform_conv_bwd_cuda.launches == launches[1] + 1


@pytest.mark.cuda
def test_k2_one_group_correlation_matches_its_plain_version(cuda):
    """K2 at G = 1 by kind: f32 within 1e-5 abs + rel of its plain
    version, bf16 within two ulps of the rounded plain result (+ 1e-5), as
    K2's other forms are held."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for C in (8, 16, 32):
        feats = torch.rand((2, 5, 24, 40, C), generator=g, device=cuda)
        proj = scenes.proj_mats(5, 40.0, 1, cuda)[:, 0][None].repeat(
            2, 1, 1, 1).contiguous()
        depth = 400.0 + 20.0 * torch.rand((2, 16, 24, 40), generator=g,
                                          device=cuda)
        go = torch.randn((2, 16, 24, 40, 1), generator=g, device=cuda)
        before = cost_volume_bwd_cuda.launches
        got = cost_volume_bwd_cuda(feats, proj, depth, go, 1, "groupwise")
        assert cost_volume_bwd_cuda.launches == before + 1
        want = plain_cost_volume_bwd(feats, proj, depth, go, 1, "groupwise")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=f"C={C}")
        fb, gb = feats.bfloat16(), go.bfloat16()
        got_b = cost_volume_bwd_cuda(fb, proj, depth, gb, 1, "groupwise")
        want_b = plain_cost_volume_bwd(fb.float(), proj, depth, gb.float(), 1,
                                       "groupwise").bfloat16().float()
        err = (got_b.float() - want_b).abs()
        assert bool((err <= 2 * _bf16_ulp(want_b) + 1e-5).all()), C


@pytest.mark.cuda
def test_a_training_step_launches_the_kernels(cuda):
    """A bf16 training step of TransMVSNet through ``MVSTrainer`` (the
    benchmark's trainer, the focal loss) launches K1, K2 and the prob conv
    once a level and the deformable conv's forward and backward once a
    conv, and nothing else of the library: no plain deformable conv, no
    FMT layer kernel (training runs its plain layers), no input block."""
    from casmvsnet_pl_tpu_torch import kernels
    cfg = load_json("configs", "transmvsnet_train.json")
    weights = program.draw_weights(cfg, 5, cuda)
    tr, state = program.trainer(cfg, weights, cuda)
    batch = scenes.make_batch(5, range(2), (128, 96), 5, 100.0, cfg, cuda)
    tr.train_step(state, batch)
    before = kernels.launch_counts()
    state, logs = tr.train_step(state, batch)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items()
           if n != before[k]}
    assert ran == {"cost_volume_cuda": 3, "cost_volume_bwd_cuda": 3,
                   "deform_conv_cuda": 9, "deform_conv_bwd_cuda": 9,
                   "prob_conv_cuda": 3}
    assert math.isfinite(float(logs["train/loss"]))
    assert all(torch.isfinite(p.grad).all()
               for p in state.model.parameters())

