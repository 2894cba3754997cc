"""K1's share of its roofline in the served cells: the least time its work
needs (``counts/kernels.k1`` at the cell's shape: both views of every pair,
the tower's tokens, width and heads) over its device time a launch, both
from the profiled requests.  The profiler's count of K1 kernels has to equal
the port's own launch count over the same requests, or the run fails."""
from perfbench.counts import kernels
from perfbench.lib.common import BenchError
from perfbench.lib.trace import kernel_stats

NAMES = ("attn_wgmma_kernel",)


def read(data, cell):
    t = data.get("trace")
    if not t:
        return None
    n, seconds = kernel_stats(t["kernels"], NAMES)
    if n != data["launches"]["k1"]:
        raise BenchError(f"the profiler saw {n} K1 kernels, the port counted "
                         f"{data['launches']['k1']}: no K1 roofline")
    if n == 0:
        return None
    v = cell["config"]["model"]["vision"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    ops, nbytes = kernels.k1(2 * cell["workload"]["batch"], tokens, v["width"], v["heads"])
    return 100.0 * kernels.bound_s(ops, nbytes) / (seconds / n)
