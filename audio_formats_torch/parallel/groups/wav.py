"""The WAV lockstep group (linear PCM; float WAV lanes take the
per-stream read)."""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ...models.wav import _LINEAR_PCM, WavDecoder
from ...ops import pcm as pcm_ops
from ..window import GroupContext, _PendingGroup, _prefetch


def group_key(d):
    """The sample kind of a linear-PCM WAV lane."""
    if isinstance(d, WavDecoder) and d._audio_format == _LINEAR_PCM:
        return d.kind
    return None


def decode(ctx: GroupContext, decs: List[WavDecoder], kind: str):
    """WAV batching: int → f32 is elementwise, so every lane of one
    sample kind rides one device call.  Each lane's raw payload bytes
    (frame-aligned, so lane boundaries stay sample boundaries) join one
    buffer that goes up as it is, and K10 unpacks and converts it on
    the device: 2 bytes a sample up for s16."""
    stats = ctx.stats
    parts = []
    counts = []  # (frames, channels) a lane
    with stats.stage("parse", "wav", cpu=True):
        for d in decs:
            frames = d.length_frames - d._frame_pos
            parts.append(np.frombuffer(d._raw_frames(frames), np.uint8))
            counts.append((frames, d.channels))
            d._frame_pos += frames
        raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    with stats.stage("enqueue", "wav"):
        out = pcm_ops.decode_bytes(torch.from_numpy(raw).to(ctx.device),
                                   kind)
        pending = [(_prefetch(out, ctx.to_device),)]
    stats.window("wav", raw.nbytes)
    # WAV decoders count decoded frames in _frame_pos
    seconds = sum(d._frame_pos / max(1, d.sample_rate) for d in decs)
    return _PendingGroup(pending, functools.partial(
        _pcm, ctx, counts, pending), seconds)


def _pcm(ctx, counts, pending):
    ((flat,),) = ctx.stats.fetched(pending)
    result = []
    off = 0
    for frames, ch in counts:
        n = frames * ch
        result.append(flat[off: off + n].reshape(frames, ch))
        off += n
    return result
