"""One call of the batch decoder, as a data loader makes it:
``BatchDecoder(list_of_bytes, device=...).decode_all(output="device")``
and ``.sync()`` on the result, each step inside the benchmark's span."""

from __future__ import annotations

#: the benchmark's spans around a call's steps, in order
SPANS = ("construct", "decode_all", "sync")
#: BatchDecoder.stats counters a call record keeps (numbers only)
STATS = ("host_ms", "host_cpu_ms", "enqueue_ms", "h2d_bytes", "windows",
         "decoded_seconds", "group_demotions")


def run(streams, device, span):
    """Decode `streams` on `device`; returns (result, stats, errors) with
    the PCM left on the device and the device's work finished."""
    from audio_formats_torch import BatchDecoder

    with span("construct"):
        dec = BatchDecoder(streams, device=device)
    with span("decode_all"):
        res = dec.decode_all(output="device")
    with span("sync"):
        res.sync()
    stats = {k: float(dec.stats.get(k, 0)) for k in STATS}
    return res, stats, list(dec.errors)


def outputs(result):
    """Each lane's PCM as a host array (None for a lane that failed)."""
    return result.to_numpy()
