"""K2's share of its roofline in the served cells: the least time the
matching of the profiled requests needs (``counts/kernels.k2``, counting for
each pair its valid sources times the targets its mask keeps) over the
device time of K2's launches (pre-pass, products, merge).  The profiler's
count of K2's product kernels has to equal the port's own launch count."""
from perfbench.counts import kernels
from perfbench.lib.common import BenchError
from perfbench.lib.trace import kernel_stats

MAIN = ("match_wgmma_kernel",)
ALL = ("compact_targets_kernel", "match_wgmma_kernel", "match_merge_kernel")


def read(data, cell):
    t = data.get("trace")
    if not t:
        return None
    n, _ = kernel_stats(t["kernels"], MAIN)
    if n != data["launches"]["k2"]:
        raise BenchError(f"the profiler saw {n} K2 kernels, the port counted "
                         f"{data['launches']['k2']}: no K2 roofline")
    _, seconds = kernel_stats(t["kernels"], ALL)
    if n == 0 or seconds <= 0 or not data.get("k2_work"):
        return None
    pipe, B = cell["config"]["pipeline"], cell["workload"]["batch"]
    m = cell["config"]["model"]
    feat_hw = (8 * m["vision"]["image_size"] // m["vision"]["patch_size"]) ** 2   # 3 upsamples
    ops, nbytes = kernels.k2(sum(data["k2_work"]), B * n, pipe["src_capacity"], feat_hw,
                             m["decoder"]["decoder_dims"][-1])
    return 100.0 * kernels.bound_s(ops, nbytes) / seconds
