"""kernel.k1_roofline: K1 (csrc/flac_lpc.cu, the LPC kernel and its lane
plan) against its roofline, over the traced calls.  The work is counted
from the streams the generator wrote: each LPC-predicted sample reads 4
bytes of residual and writes 4 of sample, and costs its predictor
order's multiply-adds.  The bound is the larger of the bytes at HBM
bandwidth and the multiply-adds at the int32 peak; the time is the
device time of K1's kernels."""

from portbench import peaks
from portbench.trace import matching_s

KERNELS = ("flac_lpc_kernel", "plan_kinds_kernel", "plan_bases_kernel",
           "plan_scatter_kernel")


def value(run):
    tr = run["trace"]
    t = matching_s(tr, KERNELS) if tr else 0.0
    if t <= 0 or not tr["work"].get("lpc_samples"):
        return None
    bound = peaks.bound_s(8.0 * tr["work"]["lpc_samples"],
                          tr["work"]["lpc_madds"])
    return 100.0 * bound / t
