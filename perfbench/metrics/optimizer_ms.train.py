"""optimizer_ms.train: device ms a step in the port's ``trainer.optimizer``
span (``engine/trainer.py``: the step's learning rate and
``optimizer.step()``)."""
from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "trainer.optimizer")
