"""Codec registry and probe cascade of the port.

The port decodes Ogg Opus, FLAC, Ogg-FLAC, WAV, QOA, Ogg Vorbis and MP3
(Layers I–III) so far, probed in the JAX cascade's order (stream.d:1586-1838:
Opus → FLAC → WAV → QOA → Vorbis → MP3 → XM → MOD).  A stream of a format
that the JAX package decodes but the port does not yet (XM, MOD) is
recognised by its magic bytes at that format's place in the cascade, and
raises an AudioFormatError that names the format, so it becomes a lane
error that says so rather than an "unrecognized encoding".
"""

from __future__ import annotations

from ..errors import AudioFormatError
from ..io.source import ByteSource
from . import flac as _flac
from . import mp3 as _mp3
from . import opus as _opus
from . import qoa as _qoa
from . import vorbis as _vorbis
from . import wav as _wav

#: MOD format tags at byte 1080 (models/mod.py of the JAX package)
_MOD_TAGS = {
    b"M.K.", b"M!K!", b"FLT4", b"4CHN", b"OKTA", b"OCTA", b"CD81", b"FA08",
    b"1CHN", b"2CHN", b"3CHN", b"5CHN", b"6CHN", b"7CHN", b"8CHN", b"9CHN",
    b"10CH", b"11CH", b"12CH", b"13CH", b"14CH", b"15CH", b"16CH",
}


def _unported_after_mp3(src: ByteSource):
    """Name of an unported format probed after MP3 (XM, MOD); None when
    none matches."""
    if bytes(src.peek(17)) == b"Extended Module: ":
        return "XM"
    view = src.view()
    if len(view) >= 1084 and bytes(view[1080:1084]) in _MOD_TAGS:
        return "MOD"
    return None


def _unported(name):
    if name is not None:
        raise AudioFormatError(
            f"Cannot decode stream: {name} is not decoded by "
            "audio_formats_torch yet.")


def probe_all(src: ByteSource, device="cuda"):
    """A decoder for the stream on `device`, or None when unrecognized.
    Raises AudioFormatError for a format the port does not decode yet."""
    for probe in (_opus.probe, _flac.probe, _wav.probe, _qoa.probe,
                  _vorbis.probe, _mp3.probe):
        src.seek(0)
        dec = probe(src, device)
        if dec is not None:
            return dec
    src.seek(0)
    _unported(_unported_after_mp3(src))
    return None
