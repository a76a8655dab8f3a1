"""host.wall_ms_per_audio_s: BatchDecoder's host stage wall
(stats["host_ms"]: the C parse and the window assembly, summed over the
window's calls) per audio second.  Exact where a call runs one group at a
time."""


def value(run):
    total = sum(c["stats"]["host_ms"] for c in run["calls"])
    return total / run["audio_s"] if run["audio_s"] else None
