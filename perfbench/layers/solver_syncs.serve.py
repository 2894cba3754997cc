"""Host-blocking synchronisations of a served request in the solvers (the
spans of ``solver_launches.serve``): PointDSC's and ICP's SVD round trips
among them, from the requests a traced run profiles with the host's
activity and spans on; nothing where the profile saw no device."""
from perfbench.lib import spans


def read(data, cell):
    return spans.layer_calls(data, "syncs", spans.SOLVERS)
