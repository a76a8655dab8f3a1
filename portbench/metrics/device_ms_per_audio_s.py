"""device_ms_per_audio_s: the card's time that decoding takes, per audio
second: the union of every kernel's, copy's and memset's interval on the
device over the whole window (a CUDA-only profiler trace), over the audio
seconds the window's calls decoded.  A loader that decodes on the card it
trains on takes this much of the card's time from the model."""


def value(run):
    dc = run.get("device_clock")
    if not dc or not dc["busy_s"] or not run["audio_s"]:
        return None
    return dc["busy_s"] * 1e3 / run["audio_s"]
