"""call.audio_rtf: the audio seconds that the window's calls decoded, over
the whole wall of the window (the realtime factor a data loader gets).
Read in a traced run, so under the profiler: the host's speed swings too
much from run to run for a bound to hold it (PERF.md, section 2)."""


def value(run):
    return run["audio_s"] / run["window_s"] if run["calls"] else None
