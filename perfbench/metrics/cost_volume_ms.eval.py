"""cost_volume_ms.eval: device ms a map in the port's three
``cascade.cost_volume`` spans (``models/cascade.py``: each level's
``build_cost_volume``, K1 and its inputs)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.cost_volume")
