"""One-shot convenience API — parity with package.d.

``save_as_wav`` (package.d:22-38) and ``to_wav`` (package.d:45-59), each
encoding on an explicit torch ``device`` (default ``"cuda"``: the quantize,
dither and pack run in the PCM kernel).  The reference's
``freeEncodedAudio`` (package.d:63) is garbage collection in Python and
intentionally has no equivalent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import AudioFileFormat, EncodingOptions
from .errors import AudioFormatError
from .stream import AudioStream


def _frames(data, channels):
    """``data`` as (frames, channels): a 1-D array is interleaved samples
    of ``channels`` (default 1)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data.reshape(-1, channels or 1)
    return data


def save_as_wav(
    data: np.ndarray,
    path,
    sample_rate: float = 44100.0,
    channels: Optional[int] = None,
    options: Optional[EncodingOptions] = None,
    device="cuda",
) -> None:
    """Encode float samples to a WAV file.

    ``data`` is (frames, channels) or interleaved 1-D (then ``channels``
    must be given, default 1).
    """
    data = _frames(data, channels)
    stream = AudioStream(device).open_to_file(
        path, AudioFileFormat.wav, sample_rate, data.shape[1], options
    )
    if stream.is_error():
        raise AudioFormatError(stream.error_message())
    stream.write_samples_float(data)
    if not stream.finalize_encoding():
        raise AudioFormatError(stream.error_message())


def to_wav(
    data: np.ndarray,
    sample_rate: float = 44100.0,
    channels: Optional[int] = None,
    options: Optional[EncodingOptions] = None,
    device="cuda",
) -> bytes:
    """Encode float samples to an in-memory WAV byte buffer."""
    data = _frames(data, channels)
    stream = AudioStream(device).open_to_buffer(
        AudioFileFormat.wav, sample_rate, data.shape[1], options
    )
    if stream.is_error():
        raise AudioFormatError(stream.error_message())
    stream.write_samples_float(data)
    out = stream.finalize_and_get_encoded_result()
    if out is None:
        raise AudioFormatError(stream.error_message())
    return out
