"""Hand-written CUDA kernels for Hopper, built from ``csrc/`` at first use."""
from .cost_volume import cost_volume_bwd_cuda, cost_volume_cuda  # noqa: F401
