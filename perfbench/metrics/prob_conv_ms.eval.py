"""prob_conv_ms.eval: device ms a map in the port's three ``cascade.prob``
spans (``models/cost_reg.py``: the 3x3x3, 8 -> 1 conv, whatever kernel
implements it)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.prob")
