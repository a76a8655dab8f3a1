"""AudioStream — the public facade, reproducing the reference's surface.

Parity target: ``struct AudioStream`` (stream.d:102): open functions
(stream.d:115,150,182,226,262), read/write (stream.d:429-908), module API
(stream.d:912-1080), seek/tell (stream.d:1095,1209), finalize
(stream.d:1270-1367), and the sticky error model (stream.d:295-316,1534).

Stream errors never raise out of this class: like the reference's ``nothrow``
design, failures of the stream (``AudioFormatError``) set a sticky flag
queryable via ``is_error()`` / ``error_message()``, and streams start life in
the error state ("Stream not initialized", stream.d:1379).

The decode probe cascade follows stream.d:1586-1838's fixed priority order:
Opus → FLAC → WAV → QOA → OGG → MP3 → XM → MOD.

Pythonic signature notes (the one deliberate deviation from the C-style API):
``read_samples_float(n)`` returns an ``(n_read, channels)`` ndarray instead of
filling a caller buffer, and ``write_samples_float(arr)`` takes an array.
CamelCase aliases (``readSamplesFloat`` …) are provided for drop-in parity.

Device: ``AudioStream(device="cuda")`` (the default) runs each codec's device
stages on that torch device (FLAC's LPC, QOA's LMS decode and encode search,
WAV's PCM convert and quantize, MP3's synthesis); ``device="cpu"`` runs
their plain PyTorch versions.  A CUDA device where there is none raises RuntimeError from the
constructor, and a kernel that fails to build, load or launch
(``ops._kernels.KernelError``) raises out of the call that ran it: the sticky
error model covers ``AudioFormatError`` only, faults of the stream and not
of the program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import models
from .device import device_of
from .config import (
    AUDIOSTREAM_UNKNOWN_LENGTH,
    AudioFileFormat,
    AudioSampleFormat,
    EncodingOptions,
)
from .errors import (
    AudioFormatError,
    K_ERROR_DECODING_ERROR,
    K_ERROR_ENCODING_ERROR,
    K_ERROR_NOT_INITIALIZED,
    K_ERROR_UNKNOWN_FORMAT,
    K_ERROR_UNSUPPORTED_ENCODING_FORMAT,
)
from .io.source import (
    ByteSink,
    ByteSource,
    CallbackSource,
    FileSink,
    FileSource,
    MemorySource,
)


class AudioStream:
    """Decode or encode one audio stream (see module docstring)."""

    def __init__(self, device="cuda"):
        self._device = device_of(device)
        self._error: Optional[str] = K_ERROR_NOT_INITIALIZED
        self._decoder = None
        self._encoder = None
        self._sink: Optional[ByteSink] = None
        self._source: Optional[ByteSource] = None
        self._format = AudioFileFormat.unknown
        self._finalized = False

    # ------------------------------------------------------------------ open
    def open_from_file(self, path) -> "AudioStream":
        self._clean_up()
        try:
            self._source = FileSource(path)
            self._start_decoding()
        except AudioFormatError as e:
            self._set_error(e.message)
        return self

    def open_from_memory(self, data) -> "AudioStream":
        self._clean_up()
        try:
            self._source = MemorySource(data)
            self._start_decoding()
        except AudioFormatError as e:
            self._set_error(e.message)
        return self

    def open_with_callbacks(self, read, seek=None, size=None) -> "AudioStream":
        self._clean_up()
        try:
            self._source = CallbackSource(read, seek, size)
            self._start_decoding()
        except AudioFormatError as e:
            self._set_error(e.message)
        return self

    def open_to_file(
        self,
        path,
        format: AudioFileFormat,
        sample_rate: float,
        channels: int,
        options: Optional[EncodingOptions] = None,
    ) -> "AudioStream":
        self._clean_up()
        try:
            self._sink = FileSink(path)
            self._start_encoding(format, sample_rate, channels, options)
        except AudioFormatError as e:
            self._set_error(e.message)
        return self

    def open_to_buffer(
        self,
        format: AudioFileFormat,
        sample_rate: float,
        channels: int,
        options: Optional[EncodingOptions] = None,
    ) -> "AudioStream":
        self._clean_up()
        try:
            self._sink = ByteSink()
            self._start_encoding(format, sample_rate, channels, options)
        except AudioFormatError as e:
            self._set_error(e.message)
        return self

    # openToMemory writes into a caller buffer in the reference
    # (stream.d:262); in Python the growable buffer covers both uses.
    open_to_memory = open_to_buffer

    def _start_decoding(self) -> None:
        decoder = models.probe_all(self._source, self._device)
        if decoder is None:
            raise AudioFormatError(K_ERROR_UNKNOWN_FORMAT)
        self._decoder = decoder
        self._format = decoder.format
        self._error = None

    def _start_encoding(self, format, sample_rate, channels, options) -> None:
        if isinstance(format, str):  # accept "wav"/"qoa" spellings
            try:
                format = AudioFileFormat[format.lower()]
            except KeyError:
                raise AudioFormatError(K_ERROR_UNSUPPORTED_ENCODING_FORMAT)
        options = options if options is not None else EncodingOptions()
        encoder = models.make_encoder(
            format, self._sink, int(sample_rate), channels, options,
            self._device
        )
        if encoder is None:
            raise AudioFormatError(K_ERROR_UNSUPPORTED_ENCODING_FORMAT)
        self._encoder = encoder
        self._format = format
        self._finalized = False
        self._error = None

    # ----------------------------------------------------------------- state
    def is_error(self) -> bool:
        return self._error is not None

    def is_valid(self) -> bool:
        return self._error is None

    def error_message(self) -> Optional[str]:
        return self._error

    def _set_error(self, message: str) -> None:
        self._error = message

    def _clean_up(self) -> None:
        # an unfinalized encoder is finalized on the way out; a stream fault
        # there is dropped with the stream, a program fault (a kernel that
        # did not launch) raises after the state is reset
        try:
            if self._encoder is not None and not self._finalized:
                try:
                    self._encoder.finalize()
                    if self._sink is not None:
                        self._sink.close()
                except AudioFormatError:
                    pass
        finally:
            # the decoder goes first: a file's map cannot close while a
            # decoder holds a view of it (MP3 keeps a slice)
            source = self._source
            self._decoder = None
            self._encoder = None
            self._sink = None
            self._source = None
            if source is not None:
                source.close()
            self._format = AudioFileFormat.unknown
            self._finalized = False
            self._error = K_ERROR_NOT_INITIALIZED

    # ------------------------------------------------------------------ info
    def get_format(self) -> AudioFileFormat:
        return self._format

    def get_num_channels(self) -> int:
        if self._decoder is not None:
            return self._decoder.channels
        if self._encoder is not None:
            return self._encoder.channels
        return 0

    def get_samplerate(self) -> float:
        if self._decoder is not None:
            return float(self._decoder.sample_rate)
        if self._encoder is not None:
            return float(self._encoder.sample_rate)
        return 0.0

    def get_length_in_frames(self) -> int:
        if self._decoder is not None:
            return self._decoder.length_frames
        return AUDIOSTREAM_UNKNOWN_LENGTH

    def is_open_for_reading(self) -> bool:
        return self._decoder is not None and not self.is_error()

    def is_open_for_writing(self) -> bool:
        return self._encoder is not None and not self.is_error()

    def is_module(self) -> bool:
        return self._format in (AudioFileFormat.mod, AudioFileFormat.xm)

    def realtime_safe(self) -> bool:
        # stream.d:325: decoding may allocate / take long ops for most codecs.
        return self._format in (AudioFileFormat.wav, AudioFileFormat.qoa)

    def can_seek(self) -> bool:
        return self._decoder is not None and hasattr(self._decoder, "seek")

    # ------------------------------------------------------------------ read
    def _read(self, frames: int, dtype) -> np.ndarray:
        empty = np.zeros((0, max(1, self.get_num_channels())), dtype=dtype)
        if self.is_error() or self._decoder is None:
            return empty
        if frames < 0:
            self._set_error(K_ERROR_DECODING_ERROR)
            return empty
        try:
            return self._decoder.read(frames, dtype=dtype)
        except AudioFormatError as e:
            self._set_error(e.message)
            return empty

    def read_samples_float(self, frames: int) -> np.ndarray:
        """Decode up to ``frames``; returns (n_read, channels) float32.

        A short result means EOF *or* error — disambiguate with
        ``is_error()`` (stream.d:424-427 contract).
        """
        return self._read(frames, np.float32)

    def read_samples_double(self, frames: int) -> np.ndarray:
        return self._read(frames, np.float64)

    # ----------------------------------------------------------------- write
    def _write(self, data: np.ndarray) -> int:
        if self.is_error() or self._encoder is None:
            return 0
        data = np.asarray(data)
        if data.ndim == 1:
            ch = self._encoder.channels
            if ch and data.shape[0] % ch == 0:
                data = data.reshape(-1, ch)
            else:
                data = data.reshape(-1, 1)
        if data.shape[1] != self._encoder.channels:
            self._set_error(K_ERROR_ENCODING_ERROR)
            return 0
        try:
            return self._encoder.write(data)
        except AudioFormatError as e:
            self._set_error(e.message)
            return 0

    def write_samples_float(self, data) -> int:
        return self._write(np.asarray(data, dtype=np.float32))

    def write_samples_double(self, data) -> int:
        return self._write(np.asarray(data, dtype=np.float64))

    # ------------------------------------------------------------- seek/tell
    def seek_position(self, frame: int, row: Optional[int] = None) -> bool:
        """Seek to absolute frame; for modules use (pattern, row)
        (stream.d:1059,1095)."""
        if self.is_error() or self._decoder is None:
            return False
        if row is not None:
            if not self.is_module():
                return False
            return self._decoder.seek_pattern(frame, row)
        if self.is_module():
            return False  # modules seek by (pattern,row) (stream.d:1103-1127)
        if not self.can_seek():
            return False
        try:
            return bool(self._decoder.seek(frame))
        except AudioFormatError as e:
            self._set_error(e.message)
            return False

    def tell_position(self) -> int:
        # modules: the reference's tellPosition ASSERTS !isModule()
        # ("seeking doesn't have the same meaning with modules",
        # stream.d:1209-1211); instead of that contract violation we
        # report frames emitted since open / last (pattern,row) seek —
        # a strict superset (module decoders track _frames_told)
        if self.is_error() or self._decoder is None:
            return AUDIOSTREAM_UNKNOWN_LENGTH
        return self._decoder.tell()

    # --------------------------------------------------------------- modules
    def _module_call(self, name: str, *args, default=AUDIOSTREAM_UNKNOWN_LENGTH):
        if self.is_error() or not self.is_module() or self._decoder is None:
            return default
        fn = getattr(self._decoder, name, None)
        if fn is None:
            return default
        return fn(*args)

    def count_module_patterns(self) -> int:
        return self._module_call("count_patterns")

    def get_module_length(self) -> int:
        return self._module_call("module_length")

    def rows_in_pattern(self, pattern: int) -> int:
        return self._module_call("rows_in_pattern", pattern)

    def tell_module_pattern(self) -> int:
        return self._module_call("tell_pattern")

    def tell_module_row(self) -> int:
        return self._module_call("tell_row")

    def frames_remaining_in_pattern(self) -> int:
        return self._module_call("frames_remaining_in_pattern")

    # -------------------------------------------------------------- finalize
    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def finalize_encoding(self) -> bool:
        if self._encoder is None or self._finalized:
            return not self.is_error()
        try:
            self._encoder.finalize()
            if self._sink is not None:
                self._sink.close()
            self._finalized = True
            return True
        except AudioFormatError as e:
            self._set_error(e.message)
            return False

    def finalize_and_get_encoded_result(self) -> Optional[bytes]:
        if self._sink is None:
            return None
        if not self.finalize_encoding():
            return None
        return self._sink.getvalue()

    # reference splits owned/disowned buffers (stream.d:1340,1355); bytes are
    # owned by the caller in Python, so both map to the same call.
    finalize_and_get_encoded_result_disown = finalize_and_get_encoded_result

    def close(self) -> None:
        self._clean_up()

    def __enter__(self) -> "AudioStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- camelCase parity alias
    openFromFile = open_from_file
    openFromMemory = open_from_memory
    openWithCallbacks = open_with_callbacks
    openToFile = open_to_file
    openToBuffer = open_to_buffer
    openToMemory = open_to_buffer
    isError = is_error
    isValid = is_valid
    errorMessage = error_message
    getFormat = get_format
    getNumChannels = get_num_channels
    getSamplerate = get_samplerate
    getLengthInFrames = get_length_in_frames
    isOpenForReading = is_open_for_reading
    isOpenForWriting = is_open_for_writing
    isModule = is_module
    realtimeSafe = realtime_safe
    canSeek = can_seek
    readSamplesFloat = read_samples_float
    readSamplesDouble = read_samples_double
    writeSamplesFloat = write_samples_float
    writeSamplesDouble = write_samples_double
    seekPosition = seek_position
    tellPosition = tell_position
    countModulePatterns = count_module_patterns
    getModuleLength = get_module_length
    rowsInPattern = rows_in_pattern
    tellModulePattern = tell_module_pattern
    tellModuleRow = tell_module_row
    framesRemainingInPattern = frames_remaining_in_pattern
    finalizeEncoding = finalize_encoding
    finalizeAndGetEncodedResult = finalize_and_get_encoded_result
    finalizeAndGetEncodedResultDisown = finalize_and_get_encoded_result
