"""runtime.gc_ms_per_audio_s: the host-clock time Python's garbage
collector took during the window (every generation; the full collections
walk the whole heap, the loader's imports with it), per audio second.
The program's allocations set how often it runs."""


def value(run):
    if run.get("gc_s") is None or not run["audio_s"]:
        return None
    return run["gc_s"] * 1e3 / run["audio_s"]
