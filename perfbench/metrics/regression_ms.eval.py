"""regression_ms.eval: device ms a map in the port's three
``cascade.regression`` spans (``models/cascade.py``: the softmax over
depth, ``depth_regression`` and the 4-bin confidence)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.regression")
