"""fmt_ms.eval: device ms a map in the port's ``cascade.fmt`` span
(``models/fmt.py``: the positional encoding and the Feature Matching
Transformer's four blocks, ``fmt.block`` inside it). None in a program
without the span."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "cascade.fmt")
