"""CostRegNet's 8 -> 1 ``prob`` conv: the kernel ``csrc/prob_conv.cu``
(``kernels.prob_conv_cuda``) against ``F.conv3d`` on the card, and its
wiring (``ops/prob_conv.py::prob_conv``) on both devices.

The tests marked ``cuda`` skip (inside the ``cuda`` fixture, never at
collection) where there is no CUDA device. On a machine with one:

    python -m pytest tests/test_torch_port_prob_conv.py -q --noconftest
"""
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from casmvsnet_pl_tpu_torch.kernels import prob_conv_cuda
from casmvsnet_pl_tpu_torch.models import cost_reg
from casmvsnet_pl_tpu_torch.models.cost_reg import CostRegNet
from casmvsnet_pl_tpu_torch.ops.prob_conv import prob_conv

SHAPES = {   # (B, D, H, W): eval's three levels, the train step's, a ragged one
    "eval_l2": (1, 48, 216, 288),
    "eval_l1": (1, 32, 432, 576),
    "eval_l0": (1, 8, 864, 1152),
    "train_l2": (2, 48, 128, 160),
    "train_l1": (2, 32, 256, 320),
    "train_l0": (2, 8, 512, 640),
    "ragged": (2, 37, 29, 53),   # D in chunks of 16, 16 and 5; W odd
}
# The kernel and cuDNN both sum the 216 products in float32, in different
# orders: they agree to float32 rounding of the sum's terms, within 1e-5 of
# sum |w x| + |bias|. A bf16 output is one rounding of that sum: within one
# bf16 ulp of the float32 conv, or within the float32 bound where
# cancellation leaves a value whose ulp is below it.
F32_TOL = 1e-5


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


def volume(shape, device, dtype=torch.float32, channels=8, seed=0):
    """A (B, C, D, H, W) view of a contiguous (B, D, H, W, C) tensor: the
    channels_last_3d layout in which CostRegNet hands the conv its input."""
    B, D, H, W = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, D, H, W, channels), generator=g, device=device)
    return x.to(dtype).permute(0, 4, 1, 2, 3)


def params(device, dtype=torch.float32, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((1, 8, 3, 3, 3), generator=g, device=device) * 216 ** -0.5
    b = torch.randn((1,), generator=g, device=device)
    return w.to(dtype), b.to(dtype)


def _module_prob(net):
    """The ``prob`` conv through ``nn.Conv3d``'s own forward."""
    return lambda c, weight, bias: net.prob(c)[:, 0]


# ------------------------------------------------------------- the CPU path

@pytest.mark.parametrize("mode", ["f32_eval", "f32_train",
                                  "bf16_autocast_train"])
def test_cost_reg_cpu_equals_module_conv(mode, monkeypatch):
    """On CPU tensors ``prob_conv`` is ``F.conv3d``: CostRegNet's output
    equals, to the bit, its output with the ``prob`` conv run as
    ``self.prob(c)[:, 0]`` on the same weights; in float32 its gradients
    do too. (Under bf16 autocast, some CPUs' bf16 conv backward differs
    from run to run on the same path.)"""
    torch.manual_seed(0)
    net = CostRegNet(8)
    with torch.no_grad():
        net.prob.bias.fill_(0.25)
    net.train(mode != "f32_eval")
    x = torch.randn(1, 8, 16, 24, 8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for patch in (False, True):
            if patch:
                monkeypatch.setattr(cost_reg, "prob_conv", _module_prob(net))
            net.zero_grad()
            with torch.autocast("cpu", dtype=torch.bfloat16,
                                enabled=mode.startswith("bf16")):
                out = net(x)
            out.float().square().sum().backward()
            runs.append((out.detach(), [p.grad.clone()
                                        for p in net.parameters()]))
    finally:
        torch.set_num_threads(threads)
    (out, grads), (ref, ref_grads) = runs
    assert out.shape == (1, 8, 16, 24) and out.dtype == ref.dtype
    assert torch.equal(out, ref)
    if mode.startswith("f32"):
        assert all(torch.equal(g, r) for g, r in zip(grads, ref_grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prob_conv_cpu_is_conv3d(dtype):
    x = volume((2, 5, 7, 9), "cpu", dtype)
    w, b = params("cpu", dtype)
    conv = nn.Conv3d(8, 1, 3, padding=1).to(dtype)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    got = prob_conv(x, conv.weight, conv.bias)
    assert torch.equal(got, conv(x)[:, 0])
    assert got.shape == (2, 5, 7, 9) and got.dtype == dtype


def test_cost_reg_state_dict_keys_unchanged():
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    want = [f"conv{i}.{k}" for i in range(7)
            for k in ["conv.weight"] + [f"bn.{s}" for s in bn]]
    want += [f"conv{i}.{k}" for i in (7, 9, 11)
             for k in ["0.weight"] + [f"1.{s}" for s in bn]]
    want += ["prob.weight", "prob.bias"]
    assert list(CostRegNet(8).state_dict()) == want
    assert CostRegNet(8).prob.weight.shape == (1, 8, 3, 3, 3)


@pytest.mark.parametrize("batch", [1, 2])
def test_prob_conv_flops_fill_what_the_counter_misses(batch, monkeypatch):
    """With the ``prob`` conv run where ``FlopCounterMode`` cannot see it,
    as its kernel runs on the card, the counted convolutions plus
    ``prob_conv_flops`` are the analytic count."""
    from casmvsnet_pl_tpu_torch.entry import (DEPTH_INTERVAL, DEPTH_MIN,
                                              entry)
    from casmvsnet_pl_tpu_torch.utils import flops

    _, (model, imgs, proj) = entry("cpu", batch=batch, img_wh=(96, 64))
    monkeypatch.setattr(cost_reg, "prob_conv", lambda c, weight, bias:
                        c.new_zeros((c.shape[0], *c.shape[2:])))
    counted = flops.conv_flops(model, imgs, proj, DEPTH_MIN, DEPTH_INTERVAL)
    prob = flops.prob_conv_flops(model, (96, 64), batch)
    assert prob == {f"cost_reg_{l}": 2 * 216 * batch * d * (64 >> l)
                    * (96 >> l) for l, d in enumerate(model.n_depths)}
    for k, n in prob.items():
        counted[k] += n
    assert counted == flops.analytic_conv_flops(model, (96, 64), 3, batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prob_conv_cuda_refuses_cpu_tensors(dtype):
    x = volume((1, 8, 8, 8), "cpu", dtype)
    w, b = params("cpu", dtype)
    before = prob_conv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        prob_conv_cuda(x, w, b)
    assert prob_conv_cuda.launches == before


# --------------------------------------------------------------- the card

def _scale(x, w, b):
    """sum |w x| + |bias| a voxel: the size of the terms the conv adds."""
    return F.conv3d(x.float().abs(), w.float().abs(), b.float().abs(), 1,
                    1)[:, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("pdtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_conv3d(cuda, shape, dtype, pdtype):
    """bf16 x with f32 parameters is the autocast step's case; f32 x with
    bf16 parameters the kernel takes too."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    x = volume(SHAPES[shape], cuda, dt[dtype])
    w, b = params(cuda, dt[pdtype])
    before = prob_conv_cuda.launches
    got = prob_conv_cuda(x, w, b)
    assert prob_conv_cuda.launches == before + 1
    assert got.shape == SHAPES[shape] and got.dtype == x.dtype
    assert got.is_contiguous()
    ref = F.conv3d(x.float(), w.float(), b.float(), 1, 1)[:, 0]
    tol = F32_TOL * _scale(x, w, b)
    err = (got.float() - ref).abs()
    if dtype == "bf16":
        tol = torch.maximum(tol, bf16_ulp(ref))
    assert (err <= tol).all(), (err - tol).max().item()


@pytest.mark.cuda
def test_kernel_refuses(cuda):
    w, b = params(cuda, torch.bfloat16)
    before = prob_conv_cuda.launches
    with pytest.raises(ValueError, match=r"\(B, 8, D, H, W\)"):
        prob_conv_cuda(volume((1, 8, 8, 8), cuda, torch.bfloat16, 16), w, b)
    x = volume((1, 8, 8, 8), cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last_3d"):
        prob_conv_cuda(x.contiguous(), w, b)
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:1 + x.numel()].view(1, 8, 8, 8, 8).permute(0, 4, 1, 2, 3)
    assert odd.is_contiguous(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="aligned"):
        prob_conv_cuda(odd, w, b)
    with pytest.raises(ValueError, match="one dtype"):
        prob_conv_cuda(x, w, b.float())
    x.requires_grad_(True)
    with pytest.raises(ValueError, match="autograd"):
        prob_conv_cuda(x, w, b)
    assert prob_conv_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("autocast", [True, False])
@pytest.mark.parametrize("shape", ["train_l2", "train_l0"])
def test_backward_equals_conv3d(cuda, shape, autocast):
    """The Function's gradients equal ``nn.Conv3d``'s to the bit, given the
    same input and output gradient: the same cuDNN backward call, the
    weight in the input's dtype as autocast casts it, and grad_weight and
    grad_bias returned in the parameters' float32."""
    dtype = torch.bfloat16 if autocast else torch.float32
    B, D, H, W = SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(3)
    leaf = torch.randn((B, D, H, W, 8), generator=g, device=cuda).to(dtype)
    grad = torch.randn((B, D, H, W), generator=g, device=cuda).to(dtype)
    conv = nn.Conv3d(8, 1, 3, padding=1).to(cuda)
    runs = []
    for f in (lambda x: conv(x)[:, 0],
              lambda x: prob_conv(x, conv.weight, conv.bias)):
        x = leaf.clone().requires_grad_(True)
        conv.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = f(x.permute(0, 4, 1, 2, 3))
        assert out.dtype == dtype
        out.backward(grad)
        runs.append((x.grad, conv.weight.grad, conv.bias.grad))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert runs[1][1].dtype == torch.float32


@pytest.mark.cuda
def test_cascade_forward_and_step_launch_three(cuda):
    """One cascade forward and one training step each run the kernel once
    a level."""
    from casmvsnet_pl_tpu_torch.entry import entry, train_entry

    fn, args = entry("cuda", img_wh=(128, 64))
    before = prob_conv_cuda.launches
    depth, conf = fn(*args)
    assert prob_conv_cuda.launches == before + 3
    assert torch.isfinite(depth).all() and torch.isfinite(conf).all()
    trainer, state, batch = train_entry("cuda", img_wh=(128, 64))
    before = prob_conv_cuda.launches
    state, logs = trainer.train_step(state, batch)
    assert prob_conv_cuda.launches == before + 3
    assert all(torch.isfinite(torch.as_tensor(v)).all()
               for v in logs.values())
