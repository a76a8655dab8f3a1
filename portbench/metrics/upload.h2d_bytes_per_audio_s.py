"""upload.h2d_bytes_per_audio_s: the bytes sent to the card
(stats["h2d_bytes"], summed over the window's calls) per audio second: a
count."""


def value(run):
    total = sum(c["stats"]["h2d_bytes"] for c in run["calls"])
    return total / run["audio_s"] if run["audio_s"] else None
