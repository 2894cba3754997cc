"""The EVA02 tower's rotary kernel R1's share of its roofline: the least time
its work needs (``counts/rope.rope`` at the cell's shape: both views of
every pair, the tower's tokens, width and heads, bf16) over its device time
a launch, both from the profiled requests.  The profiler's count of R1
kernels has to equal the port's own launch count over the same requests
(``launch_counts()["rope"]``), or the run fails.  Nothing where the program
counts no R1 launches (it has no such kernel)."""
from perfbench.counts import kernels, peaks
from perfbench.counts import rope
from perfbench.lib.common import BenchError
from perfbench.lib.trace import kernel_stats

NAMES = ("rope_qk_kernel",)


def read(data, cell):
    t = data.get("trace")
    counted = (data.get("launches") or {}).get("rope")
    if not t or counted is None:
        return None
    n, seconds = kernel_stats(t["kernels"], NAMES)
    if n != counted:
        raise BenchError(f"the profiler saw {n} R1 kernels, the port counted {counted}: "
                         "no R1 roofline")
    if n == 0:
        return None
    v = cell["config"]["model"]["vision"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    ops, nbytes = rope.rope(2 * cell["workload"]["batch"], tokens, v["width"], v["heads"])
    return 100.0 * kernels.bound_s(ops, nbytes, peaks.F32_FLOPS) / (seconds / n)
