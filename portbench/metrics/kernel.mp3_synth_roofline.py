"""kernel.mp3_synth_roofline: K15 (csrc/mp3_dsp.cu, MP3's polyphase
synthesis after K14) against its roofline, over the traced calls.  The
work is counted from the streams the generator wrote: for each
granule-channel the function's own bytes, its 576 float32 subband slots
in and its 576 float32 PCM samples out (4,608 B).  The bound is those
bytes at HBM bandwidth; the time is the device time of K15's kernel.  K15
reads 34 slots a granule-channel (16 of them its history), so the share
stays under ~69%.  None where the trace holds no such kernel."""

from portbench import peaks
from portbench.trace import matching_s

KERNELS = ("mp3_synth_kernel",)


def value(run):
    tr = run["trace"]
    t = matching_s(tr, KERNELS) if tr else 0.0
    if t <= 0 or not tr["work"].get("huff_gc"):
        return None
    return 100.0 * peaks.bound_s(576 * 8 * tr["work"]["huff_gc"]) / t
