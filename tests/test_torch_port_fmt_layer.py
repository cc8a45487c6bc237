"""The FMT's LoFTR layer (``ops/fmt_layer.py``, ``kernels/fmt_layer.py``,
``csrc/fmt_layer.cu``).

On the CPU: the plain version against the encoder layer's own modules
(``nn.Linear``, ``nn.LayerNorm``) in float32, for a self layer and a cross
layer whose source sequence i serves queries i r .. i r + r - 1; the
dispatch of self and cross layers over a (B, V, L, C) buffer; the
wrapper's refusals; the port's FMT against the benchmark's reference FMT
(``perfbench/reference/transmvsnet.py``). LayerNorm weights and biases are
drawn, not left at the identity.

The tests marked ``cuda`` hold the kernel against the plain version at a
ragged L, at B = 2 with 5 views and at the eval shape's 62,208 tokens, pin
its launches, its bits from call to call, the absence of PyTorch's
LayerNorm from the FMT, and its refused backward; they skip (inside the
``cuda`` fixture, never at collection) where there is no CUDA device. On a
machine with one:

    python -m pytest tests/test_torch_port_fmt_layer.py --noconftest -m cuda
"""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from casmvsnet_pl_tpu_torch.kernels.fmt_layer import (  # noqa: E402
    WEIGHT_SHAPES, fmt_layer_cuda)
from casmvsnet_pl_tpu_torch.models.fmt import FMT, EncoderLayer  # noqa: E402
from casmvsnet_pl_tpu_torch.ops.fmt_layer import (  # noqa: E402
    fmt_layer, linear_attention, plain_fmt_layer, plain_fmt_views)
from perfbench.reference import transmvsnet as ref_tm  # noqa: E402

C, HEADS = 32, 8


def _drawn(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` with every parameter drawn: Linear weights at deviation
    sqrt(1 / fan_in), LayerNorm weights 1 + N(0, 0.3), biases N(0, 0.3)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.3 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** .5)
    return module


def _module_forward(layer: EncoderLayer, x, source):
    """The encoder layer's forward through its own modules, as the port
    ran it before the layer had a kernel."""
    N, L, _ = x.shape
    Ns, S = source.shape[:2]
    dim = C // layer.nhead
    q = layer.q_proj(x).view(N, L, layer.nhead, dim)
    k = layer.k_proj(source).view(Ns, S, layer.nhead, dim)
    v = layer.v_proj(source).view(Ns, S, layer.nhead, dim)
    message = linear_attention(q, k, v).reshape(N, L, C)
    message = layer.norm1(layer.merge(message))
    message = layer.norm2(layer.mlp(torch.cat([x, message], dim=2)))
    return x + message


@pytest.mark.parametrize("N,L,Ns,S", [(3, 50, 3, 50), (8, 50, 2, 37)],
                         ids=["self", "cross_r4_b2"])
def test_the_plain_layer_is_the_modules_forward(N, L, Ns, S):
    layer = _drawn(EncoderLayer(C, HEADS), N + S)
    g = torch.Generator().manual_seed(S)
    x = torch.randn((N, L, C), generator=g)
    source = x if N == Ns else torch.randn((Ns, S, C), generator=g)
    with torch.no_grad():
        got = plain_fmt_layer(x, source, layer.weights(), HEADS)
        want = _module_forward(layer, x, source)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cross", [False, True])
def test_the_dispatch_takes_every_view_or_the_sources(cross):
    """On the CPU a self layer is the plain layer over all B x V views, a
    cross layer over the B x (V - 1) source views against each scene's
    reference (source i serving queries 4 i .. 4 i + 3), the reference
    left as it is."""
    B, V, L = 2, 5, 30
    layer = _drawn(EncoderLayer(C, HEADS), 11)
    views = torch.randn((B, V, L, C), generator=torch.Generator()
                        .manual_seed(3))
    with torch.no_grad():
        got = fmt_layer(views, layer.weights(), HEADS, cross)
        if cross:
            want = views.clone()
            for b in range(B):
                for v in range(1, V):
                    want[b, v] = _module_forward(
                        layer, views[b, v][None], views[b, 0][None])[0]
        else:
            want = _module_forward(layer, views.reshape(B * V, L, C),
                                   views.reshape(B * V, L, C)
                                   ).view(B, V, L, C)
    assert got.shape == views.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if cross:
        assert torch.equal(got[:, 0], views[:, 0])


def _weights(dtype=torch.float32, device="cpu"):
    return [torch.zeros(s, dtype=dtype, device=device) for s in WEIGHT_SHAPES]


@pytest.mark.parametrize("case", ["cpu", "channels", "heads", "dtype",
                                  "strides", "weights"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    views, weights, nhead = torch.zeros((1, 2, 8, C)), _weights(), HEADS
    match = {"cpu": "CUDA tensors", "channels": "must be",
             "heads": "8 heads", "dtype": "dtype", "strides": "contiguous",
             "weights": "weights must be"}[case]
    if case == "channels":
        views = torch.zeros((1, 2, 8, 16))
    elif case == "heads":
        nhead = 4
    elif case == "dtype":
        views = views.half()
    elif case == "strides":
        views = torch.zeros((1, 2, C, 8)).transpose(2, 3)
    elif case == "weights":
        weights = _weights(torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fmt_layer_cuda(views, weights, nhead, False)


@pytest.mark.parametrize("B,V,h,w", [(1, 3, 6, 8), (2, 4, 5, 7)])
def test_the_fmt_matches_the_references(B, V, h, w):
    """The port's FMT, its layers through ``fmt_layer`` on the CPU, against
    the reference's, view by view, on the same drawn weights."""
    ref = _drawn(ref_tm.FMT(C, HEADS, 4), B * V + h)
    port = FMT(C, HEADS, 4)
    port.load_state_dict(ref.state_dict(), strict=True)
    feats = torch.randn((B, V, h, w, C), generator=torch.Generator()
                        .manual_seed(w))
    with torch.no_grad():
        got = port(feats)
        want = ref([feats[:, v].permute(0, 3, 1, 2) for v in range(V)])
    for v in range(V):
        torch.testing.assert_close(got[:, v], want[v].permute(0, 2, 3, 1),
                                   rtol=1e-5, atol=1e-5)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# float32: each product is three bf16 products (hi hi, lo hi, hi lo), within
# ~2^-16 of its terms, and two LayerNorms bring the outputs to unit scale
F32_TOL = 2e-4
# bf16: the kernel's largest gap to the plain float32 layer on the same bf16
# values, over the plain bf16 module's own largest gap: the kernel rounds
# once, the module after every operator
BF16_FACTOR = 1.0


def _layer_inputs(B, V, L, seed, device):
    layer = _drawn(EncoderLayer(C, HEADS), seed).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    views = torch.randn((B, V, L, C), generator=g, device=device)
    return layer, views


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("B,V,L", [(1, 2, 1000), (2, 5, 1000),
                                   (1, 5, 62208)])
def test_the_layer_kernel_matches_its_plain_version(cuda, B, V, L, cross):
    layer, views = _layer_inputs(B, V, L, L + B, cuda)
    with torch.no_grad():
        weights = [w.detach() for w in layer.weights()]
        want = plain_fmt_views(views, weights, HEADS, cross)
        got = fmt_layer_cuda(views.clone(), weights, HEADS, cross)
        err = (got - want).abs().max().item()
        assert err <= F32_TOL, err
        if cross:
            assert torch.equal(got[:, 0], views[:, 0])
        vb, wb = views.bfloat16(), [w.bfloat16() for w in weights]
        exact = plain_fmt_views(vb.float(), [w.float() for w in wb], HEADS,
                                cross)
        module = (plain_fmt_views(vb, wb, HEADS, cross).float()
                  - exact).abs().max()
        got = fmt_layer_cuda(vb.clone(), wb, HEADS, cross)
        assert got.dtype == torch.bfloat16
        gap = (got.float() - exact).abs().max()
        assert gap <= BF16_FACTOR * module, (gap.item(), module.item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_fmt_through_the_kernels_matches_its_plain_version(cuda, dtype):
    """The whole FMT at the eval shape (5 views of 216 x 288) and at B = 2
    with a ragged token count: 16 launches a forward, every layer through
    the kernels, against the same FMT on the CPU in float32."""
    for B, V, h, w in ((1, 5, 216, 288), (2, 5, 25, 40)):
        # the weights and the input at dtype's values, on the CPU
        fmt = _drawn(FMT(C, HEADS, 4), h).to(dtype).float()
        feats = torch.randn((B, V, h, w, C), generator=torch.Generator()
                            .manual_seed(w)).to(dtype)
        with torch.no_grad():
            want = fmt(feats.float())
            card = FMT(C, HEADS, 4).to(cuda, dtype)
            card.load_state_dict(fmt.state_dict())
            before = fmt_layer_cuda.launches
            got = card(feats.to(cuda)).float().cpu()
            assert fmt_layer_cuda.launches - before == 16
            if dtype == torch.float32:
                assert (got - want).abs().max().item() <= 4 * F32_TOL
            else:
                plain = fmt.to(dtype)(feats).float()
                assert (got - want).abs().max() <= BF16_FACTOR * (
                    plain - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True])
def test_two_calls_give_the_same_bits(cuda, cross):
    layer, views = _layer_inputs(1, 5, 62208, 7, cuda)
    views = views.bfloat16()
    with torch.no_grad():
        weights = [w.detach().bfloat16() for w in layer.weights()]
        a = fmt_layer_cuda(views.clone(), weights, HEADS, cross)
        b = fmt_layer_cuda(views.clone(), weights, HEADS, cross)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_fmt_runs_no_layer_norm_of_pytorch(cuda):
    from torch.profiler import ProfilerActivity, profile
    fmt = _drawn(FMT(C, HEADS, 4), 5).to(cuda, torch.bfloat16)
    feats = torch.randn((1, 5, 54, 72, C), device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode():
        fmt(feats)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fmt(feats)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "layer_norm" in n], names
    assert sum("fmt_layer_" in n for n in names) == 2, names


@pytest.mark.cuda
def test_a_backward_through_the_kernel_raises(cuda):
    """The kernel records no graph: it refuses a tensor that needs a
    gradient, and ``fmt_layer`` takes the plain layer under autograd
    there, with the plain layer's gradients."""
    layer, views = _layer_inputs(1, 2, 100, 3, cuda)
    x = views.requires_grad_() * 1.0
    with pytest.raises(ValueError, match="autograd"):
        fmt_layer_cuda(x, layer.weights(), HEADS, False)
    out = fmt_layer(x, layer.weights(), HEADS, False)
    (got,) = torch.autograd.grad(out.square().sum(), views)
    want_out = plain_fmt_views(views * 1.0, layer.weights(), HEADS, False)
    (want,) = torch.autograd.grad(want_out.square().sum(), views)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
