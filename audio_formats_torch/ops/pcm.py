"""PCM sample-format conversion: the host half.

The quantization scales and the exact round-half-up float → int quantizer
that the encoders run on the host (wav.d:487-525).  The device kernels of
the JAX package's ``ops/pcm.py`` (exactly rounded int → f32, the on-device
quantize and its TPDF dither) come with the WAV slice.
"""

from __future__ import annotations

import numpy as np

# Quantization scales per sample format (wav.d: 127.0 / 32767.0 / 8388607.0).
SCALE = {"u8": 127.0, "s16": 32767.0, "s24": 8388607.0, "s32": 2147483648.0}
# Power-of-two factor with scale = 2^m - 1 (for the exact TwoSum quantize
# of the WAV slice).
POW2 = {"u8": 128.0, "s16": 32768.0, "s24": 8388608.0}


def quantize_float_to_int_np(x: np.ndarray, kind: str) -> np.ndarray:
    """Exact no-dither quantize in double math (reference semantics
    wav.d:487-525): what the QOA encoders feed their search."""
    scale = SCALE[kind]
    xd = np.clip(x.astype(np.float64), -1.0, 1.0)
    k = np.floor(xd * scale + 0.5)
    k = np.clip(k, -scale, scale)
    return k.astype(np.int32)
