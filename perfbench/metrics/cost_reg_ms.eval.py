"""cost_reg_ms.eval: device ms a map in the port's three
``cascade.cost_reg`` spans less the ``cascade.prob`` spans inside them
(``models/cost_reg.py``: the 3D U-Net's convolutions, BatchNorm and
transposed convolutions, without the final 8 -> 1 conv)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.cost_reg", self_time=True)
