"""upload.enqueue_ms_per_audio_s: the wall of each window's upload and
dispatch (stats["enqueue_ms"], summed over the window's calls) per audio
second."""


def value(run):
    total = sum(c["stats"]["enqueue_ms"] for c in run["calls"])
    return total / run["audio_s"] if run["audio_s"] else None
