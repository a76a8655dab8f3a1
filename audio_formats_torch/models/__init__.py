"""Codec registry and probe cascade of the port.

The decode probe order matches stream.d:1586-1838:
Opus → FLAC → WAV → QOA → OGG(Vorbis) → MP3 → XM → MOD.
Each probe receives the source rewound to byte 0 and the cascade's torch
`device`, and returns a decoder or None; probes must not raise for "not my
format" (only for genuinely corrupt streams of their own format, once
committed by magic bytes).  Every decoder runs its device stages, where it
has any, on `device`; asking for a CUDA device where there is none raises
RuntimeError.
"""

from __future__ import annotations

from ..config import AudioFileFormat, EncodingOptions
from ..io.source import ByteSink, ByteSource
from . import flac as _flac
from . import mod as _mod
from . import mp3 as _mp3
from . import opus as _opus
from . import qoa as _qoa
from . import vorbis as _vorbis
from . import wav as _wav
from . import xm as _xm

_PROBES = (_opus.probe, _flac.probe, _wav.probe, _qoa.probe, _vorbis.probe,
           _mp3.probe, _xm.probe, _mod.probe)


def probe_all(src: ByteSource, device="cuda"):
    """A decoder for the stream on `device`, or None when unrecognized."""
    for probe in _PROBES:
        src.seek(0)
        dec = probe(src, device)
        if dec is not None:
            return dec
    return None


def make_encoder(
    format: AudioFileFormat,
    sink: ByteSink,
    sample_rate: int,
    channels: int,
    options: EncodingOptions,
    device="cuda",
):
    """An encoder of `format` (WAV or QOA) writing into `sink` on `device`,
    or None for a format that is not encoded."""
    if format == AudioFileFormat.wav:
        return _wav.WavEncoder(sink, sample_rate, channels, options, device)
    if format == AudioFileFormat.qoa:
        return _qoa.QoaEncoder(sink, sample_rate, channels, options, device)
    return None
