"""features_ms.eval: device ms a map in the port's ``cascade.features``
span (``models/cascade.py``: FeatureNet over every view)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.features")
