"""kernels_per_step: device kernels launched a step on rank 0, from the
profiler's trace: a count of the host's launch path (autograd, every
wrapper's launch, SyncBN's Python-issued operations)."""
from perfbench.readers import kernel_seconds, per_unit


def read(run):
    n, _ = kernel_seconds(run, lambda k: True)
    return per_unit(run, float(n)) if n else None
