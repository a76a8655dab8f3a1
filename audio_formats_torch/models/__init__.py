"""Codec registry and probe cascade of the port.

The port decodes FLAC, Ogg-FLAC and QOA so far, probed in the JAX
cascade's order (stream.d:1586-1838).  A stream of a format that the JAX
package decodes but the port does not yet is recognised by its magic bytes
and raises an AudioFormatError that names the format, so it becomes a lane
error that says so rather than an "unrecognized encoding".
"""

from __future__ import annotations

from ..errors import AudioFormatError
from ..io import ogg
from ..io.source import ByteSource
from . import flac as _flac
from . import qoa as _qoa

#: MOD format tags at byte 1080 (models/mod.py of the JAX package)
_MOD_TAGS = {
    b"M.K.", b"M!K!", b"FLT4", b"4CHN", b"OKTA", b"OCTA", b"CD81", b"FA08",
    b"1CHN", b"2CHN", b"3CHN", b"5CHN", b"6CHN", b"7CHN", b"8CHN", b"9CHN",
    b"10CH", b"11CH", b"12CH", b"13CH", b"14CH", b"15CH", b"16CH",
}


def _mp3_sync(h: bytes) -> bool:
    """An MPEG audio frame header (models/mp3.py:_hdr_valid)."""
    return (h[0] == 0xFF
            and ((h[1] & 0xF0) == 0xF0 or (h[1] & 0xFE) == 0xE2)
            and ((h[1] >> 1) & 3) != 0
            and (h[2] >> 4) != 15
            and ((h[2] >> 2) & 3) != 3)


def unported_format(src: ByteSource):
    """Name of a format the port does not decode yet, sniffed from its
    magic bytes; None when none matches."""
    head = bytes(src.peek(64))
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "WAV"
    if head[:17] == b"Extended Module: ":
        return "XM"
    if head[:4] == b"OggS":
        view = src.view()
        page = ogg.parse_page(view, 0)
        if page is not None:
            body = bytes(view[page.body_offset:page.body_offset + 8])
            if body[:7] == b"\x01vorbis":
                return "Ogg Vorbis"
            if body == b"OpusHead":
                return "Ogg Opus"
        return None
    view = src.view()
    if len(view) >= 1084 and bytes(view[1080:1084]) in _MOD_TAGS:
        return "MOD"
    if head[:3] == b"ID3" or (len(head) >= 4 and _mp3_sync(head[:4])):
        return "MP3"
    return None


def probe_all(src: ByteSource, device="cuda"):
    """A decoder for the stream on `device`, or None when unrecognized.
    Raises AudioFormatError for a format the port does not decode yet."""
    for probe in (_flac.probe, _qoa.probe):
        src.seek(0)
        dec = probe(src, device)
        if dec is not None:
            return dec
    src.seek(0)
    name = unported_format(src)
    if name is not None:
        raise AudioFormatError(
            f"Cannot decode stream: {name} is not decoded by "
            "audio_formats_torch yet.")
    return None
