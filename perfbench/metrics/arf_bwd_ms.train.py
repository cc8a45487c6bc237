"""arf_bwd_ms.train: device ms a step in the port's ``arf.backward`` spans
(``ops/deform_conv.py``: each deformable conv's backward kernel, on
autograd's thread; attribute ``level``). None in a program without the
span."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "arf.backward")
