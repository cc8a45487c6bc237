"""idle_pct.eval: the share of the traced eval window (%) in which no
operation ran on the card: 1 - the union of its kernel, copy and set
intervals over the window (``trace.py``)."""
from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
