"""Launch one LoFTR encoder layer of TransMVSNet's Feature Matching
Transformer, ``csrc/fmt_layer.cu``.

One wrapper with its own launch count, ``fmt_layer_cuda``, over the shared
library that ``kernels/library.py`` builds from ``csrc/``. It replaces
no TPU kernel (the JAX package has no TransMVSNet). Plain version:
``ops/fmt_layer.py::plain_fmt_layer``. A layer is two launches, counted
one by one: the reduction over the source tokens, then the pass over the
query tokens. The wrapper is a raw launch that records no autograd graph;
``ops/fmt_layer.py::fmt_layer`` calls it on CUDA tensors. There is no
fallback: on a CUDA tensor the wrapper launches its kernels or raises.
"""
from __future__ import annotations

import torch

from .library import (DTYPE_CODES, LIBRARY, Kernel, check_device,
                      check_layout)

Tensor = torch.Tensor

D_MODEL = 32
HEADS = 8
KV_FLOATS = 160         # KV_h (8 x 4 x 4) and ksum_h (8 x 4) a source
KV_TOKENS = 256         # source tokens a block of the reduction sums
# q, k, v, merge, mlp.0, mlp.2, norm1 weight and bias, norm2 weight and bias
WEIGHT_SHAPES = ((D_MODEL, D_MODEL),) * 4 + (
    (2 * D_MODEL, 2 * D_MODEL), (D_MODEL, 2 * D_MODEL)) + ((D_MODEL,),) * 4


class FmtLayerKernel(Kernel):
    """A LoFTR encoder layer in place, ``csrc/fmt_layer.cu``: two launches."""

    def __init__(self, *args):
        super().__init__(*args)
        self._counters = {}     # device -> int32 zeros the reduction resets

    def __call__(self, views: Tensor, weights, nhead: int,
                 cross: bool) -> Tensor:
        """views (B, V, L, 32) f32|bf16; weights the layer's ten tensors of
        views' dtype in the order of ``WEIGHT_SHAPES``; all contiguous and
        16-byte aligned; nhead 8. A self layer (``cross`` False)
        updates every view from itself; a cross layer updates views 1..V-1
        of each scene from its view 0 and leaves view 0 as it is. Returns
        views, updated in place, with no autograd graph. The layers of one
        device share the reduction's counters: launch them on one stream."""
        if views.ndim != 4 or views.shape[-1] != D_MODEL:
            raise ValueError(f"views must be (B, V, L, {D_MODEL}), got "
                             f"{tuple(views.shape)}")
        if nhead != HEADS:
            raise ValueError(f"{self.name} takes {HEADS} heads, got {nhead}")
        if views.dtype not in DTYPE_CODES:
            raise ValueError(f"views dtype {views.dtype} not in "
                             f"{list(DTYPE_CODES)}")
        if len(weights) != len(WEIGHT_SHAPES) or any(
                tuple(w.shape) != s or w.dtype != views.dtype
                for w, s in zip(weights, WEIGHT_SHAPES)):
            raise ValueError(f"weights must be {views.dtype} of shapes "
                             f"{WEIGHT_SHAPES}, got "
                             f"{[(w.dtype, tuple(w.shape)) for w in weights]}")
        B, V, L, _ = views.shape
        if cross and V < 2:
            raise ValueError("a cross layer needs a reference and a source "
                             "view")
        check_layout(self.name, (views, *weights))
        dev = check_device(self.name, (views, *weights),
                           "; training runs ops.fmt_layer.plain_fmt_layer")
        if not views.numel():
            return views
        sources = B if cross else B * V
        nblk = -(-L // KV_TOKENS)
        kv = views.new_empty((sources, KV_FLOATS), dtype=torch.float32)
        partial = views.new_empty((sources * nblk * KV_FLOATS,),
                                  dtype=torch.float32)
        count = self._counters.get(dev)
        if count is None or count.numel() < sources:
            count = torch.zeros(max(sources, 64), dtype=torch.int32,
                                device=views.device)
            self._counters[dev] = count
        args = (views.data_ptr(), *(w.data_ptr() for w in weights),
                kv.data_ptr(), partial.data_ptr(), partial.numel(),
                count.data_ptr(), count.numel(), B, V, L, int(cross))
        code = DTYPE_CODES[views.dtype]
        self._launch(dev, *args, 0, code)
        self._launch(dev, *args, 1, code)
        return views


fmt_layer_cuda = FmtLayerKernel(LIBRARY, "fmt_layer_cuda", "fmt_layer_fwd")
