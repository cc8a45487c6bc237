"""CostRegNet's input block at one input channel (conv 1 -> 8, eval
BatchNorm, leaky ReLU 0.01): the kernel ``csrc/in_conv.cu``
(``kernels.in_conv_cuda``) against its plain version on the card, and its
wiring (``ops/in_conv.py::in_conv``, ``CostRegNet``'s dispatch) on both
devices.

The tests marked ``cuda`` skip (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_in_conv.py -q --noconftest
"""
import pytest
import torch
import torch.nn.functional as F

from casmvsnet_pl_tpu_torch.kernels import in_conv_cuda
from casmvsnet_pl_tpu_torch.models import cost_reg
from casmvsnet_pl_tpu_torch.models.blocks import ConvBnAct
from casmvsnet_pl_tpu_torch.models.cost_reg import CostRegNet
from casmvsnet_pl_tpu_torch.ops.in_conv import in_conv, plain_in_conv

SHAPES = {   # (B, D, H, W): eval's three levels at 1152x864 and a ragged one
    "eval_l2": (1, 48, 216, 288),
    "eval_l1": (1, 32, 432, 576),
    "eval_l0": (1, 8, 864, 1152),
    "ragged": (2, 37, 29, 53),   # D, H and W off the 8 x 8 x 32 block tile
}
# float32: x and the weights go into the tensor cores as bf16 hi + lo (the
# lo lo product dropped), so each product is within 3 x 2^-16 of its size
# (each half's rounding 2^-8 of what it holds, 2^-16 of the value) and the
# float32 sums add 27 roundings of 2^-24: within 2^-14 of the terms'
# sizes, sum |w x| |scale| + |mean scale| + |beta|, with scale = gamma /
# sqrt(var + eps). bf16 x and weights: the products are exact and the sum
# is float32, rounded once to bf16: within one bf16 ulp of the float32
# block on the same bf16 values, or within the float32 bound where
# cancellation leaves a value whose ulp is below it.
F32_TOL = 2.0 ** -14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def bf16_ulp(x):
    """Spacing of bf16 numbers at x (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - 8)


def volume(shape, device, dtype=torch.float32, seed=0):
    """A (B, 1, D, H, W) view of a contiguous (B, D, H, W, 1) tensor: the
    one-group correlation volume as CostRegNet hands it to ``conv0``."""
    B, D, H, W = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, D, H, W, 1), generator=g, device=device)
    return x.to(dtype).permute(0, 4, 1, 2, 3)


def block(device, dtype=torch.float32, seed=1):
    """``ConvBnAct(1, 8)`` in eval mode with drawn weights and BatchNorm
    statistics far from the identity: a kernel that skipped or misread any
    of gamma, beta, mean or var would fail."""
    torch.manual_seed(seed)
    m = ConvBnAct(1, 8, dims=3).eval()
    with torch.no_grad():
        m.conv.weight.normal_(0.0, 27 ** -0.5)
        m.bn.weight.uniform_(0.5, 2.0).mul_(torch.tensor(
            [1.0, -1.0] * 4))
        m.bn.bias.normal_(0.0, 0.5)
        m.bn.running_mean.normal_(0.0, 0.5)
        m.bn.running_var.uniform_(0.25, 4.0)
    return m.to(device=device, dtype=dtype)


def kernel_args(m):
    return (m.conv.weight, m.bn.weight, m.bn.bias, m.bn.running_mean,
            m.bn.running_var, m.bn.eps)


# ------------------------------------------------------------- the CPU path

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 16, 24), (2, 5, 7, 9),
                                   (1, 3, 1, 33)])
def test_plain_in_conv_is_the_block(shape, dtype):
    """``plain_in_conv`` equals, to the bit, ``ConvBnAct``'s forward in eval
    mode, also at shapes off the kernel's tile (odd and ragged)."""
    m = block("cpu", dtype)
    x = volume(shape, "cpu", dtype)
    with torch.no_grad():
        got, want = plain_in_conv(x, m.conv, m.bn), m(x)
    assert got.shape == (shape[0], 8, *shape[1:]) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(in_conv(x, m.conv, m.bn), want)


def _recording(calls, fn):
    def run(x, conv, bn):
        calls.append(x.shape)
        return fn(x, conv, bn)
    return run


def _drawn_cost_reg(in_channels, seed=0):
    torch.manual_seed(seed)
    net = CostRegNet(in_channels)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 2.0)
                m.bias.normal_(0.0, 0.5)
                m.running_mean.normal_(0.0, 0.5)
                m.running_var.uniform_(0.25, 4.0)
    return net


def test_cost_reg_one_channel_eval_cpu_is_unchanged(monkeypatch):
    """``CostRegNet(1)`` in eval mode on the CPU goes through ``in_conv``
    and gives, to the bit, the output of ``conv0``'s own forward."""
    net = _drawn_cost_reg(1).eval()
    x = torch.randn(1, 16, 24, 32, 1)
    calls = []
    monkeypatch.setattr(cost_reg, "in_conv", _recording(calls, in_conv))
    with torch.no_grad():
        got = net(x)
        monkeypatch.setattr(cost_reg, "in_conv",
                            lambda x, conv, bn: net.conv0(x))
        want = net(x)
    assert calls == [(1, 1, 16, 24, 32)]
    assert got.shape == (1, 16, 24, 32) and torch.equal(got, want)


@pytest.mark.parametrize("case", ["c1_eval", "c1_eval_grad", "c1_train",
                                  "c8_eval"])
def test_dispatch_takes_in_conv_only_at_one_channel_in_eval(case,
                                                            monkeypatch):
    """The new op runs at one input channel in eval mode where autograd
    records nothing; at C = 8, in train mode, or where a gradient is needed
    ``conv0`` (``ConvBnAct``) runs as before."""
    channels = 8 if case == "c8_eval" else 1
    net = _drawn_cost_reg(channels)
    net.train(case == "c1_train")
    calls, block_calls = [], []
    monkeypatch.setattr(cost_reg, "in_conv", _recording(calls, in_conv))
    net.conv0.register_forward_hook(lambda *a: block_calls.append(1))
    x = torch.randn(1, 8, 16, 16, channels)
    with torch.set_grad_enabled(case in ("c1_eval_grad", "c1_train")):
        out = net(x)
    took = case == "c1_eval"
    assert (len(calls), len(block_calls)) == ((1, 0) if took else (0, 1))
    assert out.requires_grad == (case != "c1_eval" and case != "c8_eval")


def test_cost_reg_state_dict_names_unchanged():
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    keys = list(CostRegNet(1).state_dict())
    assert keys[:6] == ["conv0.conv.weight"] + [f"conv0.bn.{s}" for s in bn]
    assert keys == list(CostRegNet(8).state_dict())
    assert CostRegNet(1).conv0.conv.weight.shape == (8, 1, 3, 3, 3)


def _refusal_cases():
    """(what, args, message): wrong shape, dtype or layout."""
    m = block("cpu")
    args = kernel_args(m)
    x = volume((1, 8, 8, 8), "cpu")
    w, ga, be, mu, va, eps = args
    yield "two channels", (volume((1, 8, 8, 8), "cpu").expand(
        1, 2, 8, 8, 8), *args), r"\(B, 1, D, H, W\)"
    yield "four dims", (x[:, 0], *args), r"\(B, 1, D, H, W\)"
    yield "float16 x", (x.half(), *args), "dtype"
    yield "float16 params", (x, w.half(), ga.half(), be.half(), mu.half(),
                             va.half(), eps), "one dtype"
    yield "mixed params", (x, w, ga.bfloat16(), be, mu, va, eps), "one dtype"
    yield "weight 8 -> 8", (x, w.expand(8, 8, 3, 3, 3), ga, be, mu, va,
                            eps), "one dtype"
    yield "short var", (x, w, ga, be, mu, va[:4], eps), "one dtype"
    yield "strided x", (volume((1, 8, 8, 16), "cpu")[..., ::2], *args), \
        "contiguous"
    yield "strided gamma", (x, w, torch.ones(16)[::2], be, mu, va, eps), \
        "contiguous"
    yield "cpu tensors", (x, *args), "CUDA"


REFUSALS = ["two channels", "four dims", "float16 x", "float16 params",
            "mixed params", "weight 8 -> 8", "short var", "strided x",
            "strided gamma", "cpu tensors"]


@pytest.mark.parametrize("case", REFUSALS)
def test_in_conv_cuda_refuses(case):
    """The wrapper refuses what the kernel does not take, before any
    launch: the checks run on the CPU's tensors up to the device's."""
    cases = {c[0]: c[1:] for c in _refusal_cases()}
    assert list(cases) == REFUSALS
    args, message = cases[case]
    before = in_conv_cuda.launches
    with pytest.raises(ValueError, match=message):
        in_conv_cuda(*args)
    assert in_conv_cuda.launches == before


# --------------------------------------------------------------- the card

def _terms(x, m):
    """The size of the terms each output sums: sum |w x| |scale| +
    |mean scale| + |beta| a voxel and channel, in float32."""
    w, ga, be, mu, va, eps = (t.float() if torch.is_tensor(t) else t
                              for t in kernel_args(m))
    scale = ga / torch.sqrt(va + eps)
    conv = F.conv3d(x.float().abs(), w.abs(), None, 1, 1)
    shape = (1, 8, 1, 1, 1)
    return conv * scale.abs().view(shape) + (mu * scale).abs().view(shape) \
        + be.abs().view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("pdtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain(cuda, shape, dtype, pdtype):
    """The kernel against ``plain_in_conv`` in float32 (TF32 off) on the
    same values, with drawn BatchNorm statistics; the output is
    channels_last_3d in x's dtype."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    x = volume(SHAPES[shape], cuda, dt[dtype])
    m = block(cuda, dt[pdtype])
    before = in_conv_cuda.launches
    with torch.no_grad():
        got = in_conv_cuda(x, *kernel_args(m))
        assert in_conv_cuda.launches == before + 1
        B, D, H, W = SHAPES[shape]
        assert got.shape == (B, 8, D, H, W) and got.dtype == x.dtype
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
        ref = plain_in_conv(x.float(), *_float_block(m))
        tol = F32_TOL * _terms(x, m)
        if dtype == "bf16":
            tol = torch.maximum(tol, bf16_ulp(ref))
        err = (got.float() - ref).abs()
    assert (err <= tol).all(), (err - tol).max().item()


def _float_block(m):
    f = block("cpu")
    f.load_state_dict({k: v.float().cpu() for k, v in m.state_dict().items()})
    f = f.to(m.conv.weight.device)
    return f.conv, f.bn


@pytest.mark.cuda
def test_kernel_refuses_a_tensor_that_needs_a_gradient(cuda):
    m = block(cuda, torch.bfloat16)
    x = volume((1, 8, 8, 32), cuda, torch.bfloat16)
    before = in_conv_cuda.launches
    with pytest.raises(ValueError, match="autograd"):
        in_conv(x.detach().requires_grad_(True), m.conv, m.bn)
    with pytest.raises(ValueError, match="autograd"):
        in_conv(x, m.conv, m.bn)        # the parameters need one
    with torch.no_grad():
        in_conv(x, m.conv, m.bn)
    assert in_conv_cuda.launches == before + 1


@pytest.mark.cuda
def test_transmvsnet_launches_three_and_casmvsnet_none(cuda):
    """One TransMVSNet forward runs the kernel once a level; a CasMVSNet
    forward (C = 8) and a training step never do."""
    from casmvsnet_pl_tpu_torch.entry import entry, train_entry

    for arch, want in (("transmvsnet", 3), ("casmvsnet", 0)):
        fn, args = entry("cuda", img_wh=(128, 64), arch=arch)
        before = in_conv_cuda.launches
        depth, conf = fn(*args)
        assert in_conv_cuda.launches == before + want, arch
        assert torch.isfinite(depth).all() and torch.isfinite(conf).all()
    trainer, state, batch = train_entry("cuda", img_wh=(128, 64))
    before = in_conv_cuda.launches
    trainer.train_step(state, batch)
    assert in_conv_cuda.launches == before
