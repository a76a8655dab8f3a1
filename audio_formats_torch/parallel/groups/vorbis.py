"""The Ogg Vorbis lockstep group."""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ...models.vorbis import VorbisDecoder
from ...ops import vorbis_win
from ..window import GroupContext, _PendingGroup, _prefetch, _upload

#: Vorbis packets a lane per device call
VORBIS_WINDOW_PACKETS = 8


def group_key(d):
    """(channels, short block, long block) of a Vorbis lane: the window
    chain's IMDCT sizes and slopes are the block sizes'."""
    if isinstance(d, VorbisDecoder):
        return d.channels, d._bs0, d._bs1
    return None


def decode(ctx: GroupContext, decs: List[VorbisDecoder], key):
    """Vorbis lockstep: the host runs the entropy stage (codebooks,
    floors, residues, coupling, floor dot) of K packets a lane; one
    upload of the window's spectra X [K, L, bs1/2] and geometry, and one
    device chain (ops/vorbis_win.vorbis_window_chain: both block sizes'
    IMDCT matmuls, then K11's lapped chain with the lap carried on the
    device) a window.  Each packet's output length follows from the
    geometry on the host, so nothing downloads until finalize(), for
    either output."""
    nch, bs0, bs1 = key
    stats, dev = ctx.stats, ctx.device
    B = len(decs)
    h = bs1 // 2
    L = B * nch
    K = VORBIS_WINDOW_PACKETS
    state = (torch.zeros((L, h), dtype=torch.float32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    host_hp = np.zeros(B, bool)  # host mirror of had_prev
    active = np.ones(B, bool)
    pending = []
    while active.any():
        with stats.stage("parse", "vorbis", cpu=True):
            X = np.zeros((K, L, h), np.float32)
            geom = np.zeros((4, K, B), np.int32)  # ls, rs, re, valid
            lens = np.zeros((K, B), np.int32)     # emitted (clamped) lengths
            for bi, d in enumerate(decs):
                k = 0
                while k < K and active[bi]:
                    if d.length_frames and d._pos >= d.length_frames:
                        active[bi] = False
                        break
                    pk = d._reader.next_packet()
                    if pk is None:
                        active[bi] = False
                        break
                    ent = d._packet_entropy(pk[0])
                    if ent is None:
                        continue
                    spec, (n, l0, r0, r1) = ent
                    X[k, bi * nch: (bi + 1) * nch, : n // 2] = spec
                    geom[:, k, bi] = (l0, r0, r1, 1)
                    ol = (r0 - l0) if host_hp[bi] else 0
                    host_hp[bi] = True
                    if d.length_frames:
                        # the final granule cuts the last packets
                        ol = min(ol, max(0, d.length_frames - d._pos))
                    lens[k, bi] = ol
                    d._pos += ol
                    k += 1
        if not geom[3].any():
            break
        with stats.stage("enqueue", "vorbis"):
            X_d, g_d = _upload(dev, X, geom)
            pcm, *st = vorbis_win.vorbis_window_chain(
                X_d, g_d[0], g_d[1], g_d[2], g_d[3], *state,
                bs0=bs0, bs1=bs1, ch=nch)
            state = tuple(st)
            pending.append((_prefetch(pcm, ctx.to_device), lens))
        stats.window("vorbis", X.nbytes + geom.nbytes)
    # Vorbis decoders count decoded frames in _pos
    seconds = sum(d._pos / max(1, d.sample_rate) for d in decs)
    return _PendingGroup(pending, functools.partial(
        _pcm, ctx, decs, pending, nch), seconds)


def _pcm(ctx, decs, pending, nch):
    outs = [[] for _ in decs]
    for arr, lens in ctx.stats.fetched(pending):   # [K, L, bs1]
        for bi in range(len(decs)):
            for k in range(arr.shape[0]):
                n = int(lens[k, bi])
                if n:
                    outs[bi].append(
                        arr[k, bi * nch: (bi + 1) * nch, :n].T)
    return [
        np.ascontiguousarray(np.concatenate(o), dtype=np.float32)
        if o else np.zeros((0, nch), np.float32)
        for o in outs
    ]
