"""idle_pct.train: the share of the traced training window (%) in which no
operation ran on rank 0's card: 1 - the union of its kernel, copy and set
intervals (NCCL's stream and compute's counted once) over the window."""
from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
