"""kernel.k3_roofline: K3 (csrc/mp3_huff.cu, the Huffman kernel and its
lane plan) against its roofline, over the traced calls.  The work is
counted from the streams the generator wrote: 576 int32 values written
for each granule-channel, and the granule-channel's Huffman bits
(part2_3_length) read once.  The bound is those bytes at HBM bandwidth;
the time is the device time of K3's kernels."""

from portbench import peaks
from portbench.trace import matching_s

KERNELS = ("mp3_huff_kernel", "plan_count_kernel", "plan_base_kernel",
           "plan_place_kernel")


def value(run):
    tr = run["trace"]
    t = matching_s(tr, KERNELS) if tr else 0.0
    if t <= 0 or not tr["work"].get("huff_gc"):
        return None
    n_bytes = 576 * 4 * tr["work"]["huff_gc"] + tr["work"]["huff_bits"] / 8
    return 100.0 * peaks.bound_s(n_bytes) / t
