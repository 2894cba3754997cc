"""Kernel-launch calls of a served request in the solvers: the program's
spans ``pipeline.solve``, ``solve.lift``, ``pointdsc.*``, ``pipeline.icp``
and ``icp.*`` (lifting, PointDSC, ICP; a CUDA graph's launch one call), from
the requests a traced run profiles with the host's activity and spans on.
Nothing where the profile missed launches (``lib/spans.launches_agree``)."""
from perfbench.lib import spans


def read(data, cell):
    return spans.layer_calls(data, "launches", spans.SOLVERS)
