"""backward_ms.train: device ms a step in the port's ``trainer.backward``
span (``engine/trainer.py``: ``zero_grad`` and ``loss.backward()``, conv
dgrad and wgrad, K2)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "trainer.backward")
