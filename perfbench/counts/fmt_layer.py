"""The least time of the FMT's layer kernels (``csrc/fmt_layer.cu``,
``fmt_layer_kv_kernel`` and ``fmt_layer_apply_kernel``) a map: LoFTR's
encoder layers of TransMVSNet's Feature Matching Transformer, ``blocks``
self layers over every view's tokens and as many cross layers from each
scene's reference view into its source views.

Bytes, each read or written once: a layer's input (n query tokens), its
source (s tokens; a self layer's source is its input, counted once) and its
output (n tokens), d values a token at ``itemsize`` bytes (bf16: 2).
Operations, as ``architectures/transmvsnet.py::fmt_flops`` counts them,
priced by the unit that runs them: the products of the projections (q and
merge 2 n d^2 each, k and v 2 s d^2 each) and of the MLP (2 n 6 d^2), which
the kernels run as bf16 ``mma.sync``, counted once at the card's dense
bf16 rate; the attention's (phi(K)^T V 2 s d d_h, phi(Q) (phi(K)^T V)
2 n d d_h, the normalizer 2 n d) on the CUDA cores at the 67 TFLOP/s
float32 rate. A layer's least time is the largest of its bytes over
3.35 TB/s and each unit's operations over its rate.
"""
from __future__ import annotations

from .flops import F32_FLOPS, HBM_BYTES_PER_S, PEAK_BF16

TENSOR_FLOPS = PEAK_BF16["NVIDIA H100 80GB HBM3"]


def layer_work(n: int, s: int, d: int, heads: int, cross: bool,
               itemsize: int = 2) -> tuple[int, int, int]:
    """(bytes, CUDA-core operations, tensor-core operations) of one layer
    over n query and s source tokens."""
    dh = d // heads
    tokens = 2 * n + (s if cross else 0)
    cuda = 2 * s * d * dh + 2 * n * d * dh + 2 * n * d
    tensor = 2 * n * d * d * 2 + 2 * s * d * d * 2 + 2 * n * 6 * d * d
    return tokens * d * itemsize, cuda, tensor


def fmt_layers(config: dict, img_wh, n_views: int, batch: int
               ) -> list[tuple[int, int, bool]]:
    """(n, s, cross) of each layer of a map, in order: the FMT on the 1/4
    level, one token a pixel."""
    W, H = img_wh
    tokens = (H >> 2) * (W >> 2)
    views = batch * n_views * tokens
    sources = batch * (n_views - 1) * tokens
    return [(views, views, False), (sources, batch * tokens, True)] \
        * config["fmt"]["blocks"]


def fmt_bound_s(config: dict, img_wh, n_views: int, batch: int,
                itemsize: int = 2) -> float:
    """The least time of every layer of a map, seconds."""
    d, heads = config["fmt"]["d_model"], config["fmt"]["heads"]
    total = 0.0
    for n, s, cross in fmt_layers(config, img_wh, n_views, batch):
        nbytes, cuda, tensor = layer_work(n, s, d, heads, cross, itemsize)
        total += max(nbytes / HBM_BYTES_PER_S, cuda / F32_FLOPS,
                     tensor / TENSOR_FLOPS)
    return total
