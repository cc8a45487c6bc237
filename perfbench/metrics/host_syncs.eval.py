"""host_syncs.eval: the port's ``host_sync`` spans a map: calls of the
program that block the host until the card's queue drains (the sites are
listed in ``PERF.md``)."""
from perfbench.spans import span_count


def read(run):
    return span_count(run, "host_sync", within="cascade.features")
