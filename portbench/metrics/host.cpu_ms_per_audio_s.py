"""host.cpu_ms_per_audio_s: the host stage's thread CPU time
(stats["host_cpu_ms"], summed over the window's calls) per audio second."""


def value(run):
    total = sum(c["stats"]["host_cpu_ms"] for c in run["calls"])
    return total / run["audio_s"] if run["audio_s"] else None
