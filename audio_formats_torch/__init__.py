"""audio_formats_torch — the PyTorch and CUDA port of audio_formats_tpu.

A batched audio decoder in two stages: a host entropy stage turns
compressed byte streams into dense tensors, and device stages written in
PyTorch, with hand-written CUDA kernels where the JAX package had Pallas
kernels, decode many streams in lockstep on one GPU.

The port decodes Ogg Opus, FLAC, Ogg-FLAC, WAV, QOA, Ogg Vorbis and MP3
(Layers I–III), and encodes QOA and WAV, so far.  Public surface:

* :class:`BatchDecoder` — ``BatchDecoder(items, device="cuda")``, then
  ``decode_all(output="numpy" | "device")``
* :func:`encode_qoa_batch` — ``encode_qoa_batch(pcms, rate, device="cuda")``
* :func:`encode_wav_batch` — ``encode_wav_batch(pcms, rate, options,
  device="cuda")``
* :mod:`config`, :mod:`errors` — the enums and the error model
"""

from . import config, errors
from .errors import AudioFormatError
from .parallel import BatchDecoder, encode_qoa_batch, encode_wav_batch

__version__ = "0.1.0"

__all__ = ["AudioFormatError", "BatchDecoder", "config", "encode_qoa_batch",
           "encode_wav_batch", "errors", "__version__"]
