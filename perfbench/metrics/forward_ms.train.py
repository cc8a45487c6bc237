"""forward_ms.train: device ms a step in the port's ``trainer.forward``
span (``engine/trainer.py``: the model under autocast and ``sl1_loss``)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "trainer.forward")
