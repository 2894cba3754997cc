"""``solver_syncs.serve``, read in the cells whose end-to-end metric is the tail
of a request's latency (``serve_p95_ms``)."""
from perfbench.lib.common import layer_reader


def read(data, cell):
    return layer_reader("solver_syncs.serve").read(data, cell)
