"""call.host_cpu_ms_per_audio_s: the process's CPU time over the window
(every thread, time.process_time), per audio second decoded.  Read in a
traced run, so under the profiler."""


def value(run):
    return run["cpu_s"] * 1e3 / run["audio_s"] if run["audio_s"] else None
