"""arf_ms.eval: device ms a map in the port's three ``cascade.arf`` spans
(``models/transmvsnet.py``: each level's offset-and-mask convs, deformable
convs, BatchNorm and ReLU). None in a program without the span."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.arf")
