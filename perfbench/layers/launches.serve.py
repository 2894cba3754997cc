"""Kernel-launch calls of a served request (``cudaLaunchKernel`` and its
kin, and ``cudaGraphLaunch``) under the program's ``engine.request`` span,
every layer's together (``forward_launches`` and ``solver_launches`` split
out the model's and the solvers'), from the requests a traced run profiles
with the host's activity and spans on.  Nothing where those calls, each
graph launch taken as the kernels it ran, and the device's kernels differ
by more than 2%: the profile then missed launches."""
from perfbench.lib import spans


def read(data, cell):
    s = data.get("spans")
    if not s or not s["counts"]["kernels"] or not spans.launches_agree(s["counts"]):
        return None
    return s["counts"]["request"]["launches"]
