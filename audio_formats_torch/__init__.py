"""audio_formats_torch — the PyTorch and CUDA port of audio_formats_tpu.

A batched audio decoder in two stages: a host entropy stage turns
compressed byte streams into dense tensors, and device stages written in
PyTorch, with hand-written CUDA kernels where the JAX package had Pallas
kernels, decode many streams in lockstep on one GPU; and the reference's
single-stream facade on the same codecs.

The port decodes Ogg Opus, FLAC, Ogg-FLAC, WAV, QOA, Ogg Vorbis, MP3
(Layers I–III), MOD and XM, and encodes QOA and WAV.  Every entry point
takes a torch ``device`` (default ``"cuda"``, which raises without a GPU).
Public surface:

* :class:`AudioStream` — ``AudioStream(device="cuda")``: the open / read /
  write / seek / tell single-stream facade, with the module API for MOD
  and XM and the sticky error model of the reference
* :func:`save_as_wav`, :func:`to_wav` — one-shot WAV encode helpers
  (package.d)
* :class:`BatchDecoder` — ``BatchDecoder(items, device="cuda")``, then
  ``decode_all(output="numpy" | "device")``: the batched decode this
  package adds over the reference (which is strictly single-stream)
* :func:`encode_qoa_batch` — ``encode_qoa_batch(pcms, rate, device="cuda")``
* :func:`encode_wav_batch` — ``encode_wav_batch(pcms, rate, options,
  device="cuda")``
* the enums and the error model of :mod:`config` and :mod:`errors`
"""

from . import config, errors
from .config import (
    AUDIOSTREAM_UNKNOWN_LENGTH,
    AudioFileFormat,
    AudioSampleFormat,
    CodecConfig,
    EncodingOptions,
)
from .errors import AudioFormatError
from .highlevel import save_as_wav, to_wav
from .parallel import BatchDecoder, encode_qoa_batch, encode_wav_batch
from .stream import AudioStream

__version__ = "0.1.0"

__all__ = [
    "AudioStream",
    "AudioFileFormat",
    "AudioSampleFormat",
    "AudioFormatError",
    "CodecConfig",
    "EncodingOptions",
    "AUDIOSTREAM_UNKNOWN_LENGTH",
    "BatchDecoder",
    "config",
    "encode_qoa_batch",
    "encode_wav_batch",
    "errors",
    "save_as_wav",
    "to_wav",
    "__version__",
]
