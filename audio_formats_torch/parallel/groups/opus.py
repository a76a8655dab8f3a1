"""The Ogg Opus lockstep groups of mapping-0 lanes (CELT-only, SILK-only,
hybrid and mode-switching), each lane put in one by ``classify`` in the
JAX package's order.  Every group returns host PCM for either output,
as the JAX package's do; multistream lanes take the per-stream read."""

from __future__ import annotations

from typing import List

import numpy as np

from ...errors import AudioFormatError
from ...models.opus import OpusDecoder, RangeDecoder, parse_packet
from ...models.silk import SilkDecoder
from ...ops import celt_dsp
from ...ops.resample import BatchedFittedUpsampler
from ..window import GroupContext, Stats, _upload

#: the mixed Opus group answers its CELT synthesis requests in buckets on
#: the device from this many lanes on; a smaller group answers them on the
#: host (CeltDecoder.synthesize, the per-stream read's own IMDCT)
OPUS_MIXED_DEVICE_MIN_LANES = 16


def classify(d):
    """The Opus group that takes lane `d`, with its key, as the JAX
    package's eligibility cascade picks it: ``("celt", channels)``,
    ``("silk", (channels, config, stereo, frames))``, ``("hybrid",
    (channels, config, stereo))``, ``("mixed", channels)``, or None for a
    lane that takes the per-stream read.  One Ogg walk and one parse of
    each packet a lane: the answer is kept on the decoder, beside the
    parsed packets (``_opus_packets``) that its group reads."""
    if not hasattr(d, "_opus_route"):
        d._opus_route = _classify(d)
    return d._opus_route


def _classify(d):
    # multistream lanes, s16 parity lanes (the reference's output grid,
    # a per-stream feature) and streams whose pages do not read take the
    # per-stream read
    if d.channel_mapping != 0 or d.s16_parity:
        return None
    try:
        pkts = d._collect_packets()
    except AudioFormatError:
        return None
    parsed = [parse_packet(data) for data in pkts]
    if not parsed or any(pk is None for pk in parsed):
        return None
    d._opus_packets = parsed
    # CELT-only with one frame size (music streams, the common case)
    if all(pk["mode"] == "celt" for pk in parsed) and \
            len({pk["frame_size"] for pk in parsed}) == 1:
        return "celt", d.channels
    # the SILK and hybrid groups upsample by the fitted kernels: a lane
    # of the reference resampler rides the mixed group
    if not d._reference_resampler:
        # SILK-only with no empty frame and one (config, stereo, frames)
        # shape (the common VoIP shape)
        shapes = {(pk["config"], pk["stereo"], len(pk["frames"]))
                  for pk in parsed}
        if len(shapes) == 1 and all(
                pk["mode"] == "silk" and all(len(f) for f in pk["frames"])
                for pk in parsed):
            return "silk", (d.channels,) + shapes.pop()
        # every packet one non-empty hybrid frame, one (config, stereo)
        shapes = {(pk["config"], pk["stereo"]) for pk in parsed}
        if len(shapes) == 1 and all(
                pk["mode"] == "hybrid" and len(pk["frames"]) == 1
                and len(pk["frames"][0]) for pk in parsed):
            return "hybrid", (d.channels,) + shapes.pop()
    # the mixed group takes every other stream that reads: its lanes
    # replay the per-stream read's own packet generator
    if all(pk["mode"] in ("silk", "celt", "hybrid") for pk in parsed):
        return "mixed", d.channels
    return None


def _key_of(group: str):
    def key(d):
        if not isinstance(d, OpusDecoder):
            return None
        route = classify(d)
        return route[1] if route is not None and route[0] == group \
            else None
    key.__doc__ = f"The {group} group's key of an Opus lane (classify)."
    return key


celt_key, silk_key, hybrid_key, mixed_key = map(
    _key_of, ("celt", "silk", "hybrid", "mixed"))


def _packets(d, group: str):
    """Lane d's parsed packets.  A lane the lattice re-probed lost its
    classification and is classified again: one that no longer lands in
    `group` raises, and the lattice isolates it."""
    route = classify(d)
    if route is None or route[0] != group:
        raise AudioFormatError(f"Opus: lane not {group}-eligible")
    return d._opus_packets


def _celt_imdct_bucket(stats: Stats, items, blocks, bs, device):
    """One bucket of a CELT lockstep step on the device: a row for each
    output channel, each packet scaled by its own imdct_scale (0.5 when
    a stereo-coded packet downmixes to a mono output,
    models/celt.py:1243-1246; a bucket of mixed scales has its rows
    pre-multiplied, exact for 0.5 and 1.0).  One upload of the spectra
    and tails to `device`, K12a (with the IMDCT matmul in front of it for
    long blocks), and one download of the packed [rows, frame + 60] output
    and new tail.  items: [(celt_decoder, params)] in row order.  Returns
    (raw [rows, frame], newtail [rows, OVERLAP//2]) as numpy."""
    frame = blocks * bs
    half = celt_dsp.HALF
    co, tails, scales = [], [], []
    for cd, p in items:
        for c in range(cd.output_channels):
            co.append(p["coeffs"][c, :frame])
            tails.append(cd.buf[c][1024: 1024 + half])
            scales.append(p["imdct_scale"])
    co = np.stack(co).astype(np.float32)
    tails = np.stack(tails).astype(np.float32)
    sc = np.asarray(scales, np.float32)
    scale = float(sc[0])
    if not np.all(sc == sc[0]):
        co *= sc[:, None]
        scale = 1.0
    rows = co.shape[0]
    (flat,) = _upload(device, np.concatenate([co.ravel(), tails.ravel()]))
    buf = celt_dsp.celt_imdct_ola_packed(
        flat[: rows * frame].view(rows, frame),
        flat[rows * frame:].view(rows, half), blocks, bs, scale)
    stats.window("opus", co.nbytes + tails.nbytes)
    packed = buf.cpu().numpy()
    stats.add("d2h_bytes", packed.nbytes)
    return packed[:, :frame], packed[:, frame:]


def _synthesize(stats: Stats, device, reqs):
    """The CELT syntheses `reqs` [(celt_decoder, params)] of one step, a
    lane's at most, on the device: one ``_celt_imdct_bucket`` a (blocks,
    blocksize) bucket.  Returns each request's (raw [frame, channels],
    newtail [OVERLAP//2, channels]), in order."""
    buckets = {}
    for j, (_, p) in enumerate(reqs):
        buckets.setdefault((p["blocks"], p["blocksize"]), []).append(j)
    out = [None] * len(reqs)
    for (blocks, bs), js in buckets.items():
        raw, newtail = _celt_imdct_bucket(
            stats, [reqs[j] for j in js], blocks, bs, device)
        row = 0
        for j in js:
            k = reqs[j][0].output_channels
            out[j] = raw[row: row + k].T, newtail[row: row + k].T
            row += k
    return out


def _gained(d, pcm):
    """A lane's PCM with its header gain applied."""
    return pcm * np.float32(d._gain) if d._gain != 1.0 else pcm


def decode_celt(ctx: GroupContext, decs: List[OpusDecoder], key):
    """CELT lockstep: the host symbol stage (C) runs a frame a lane a
    step; each (blocks, blocksize) bucket of the step then runs on the
    device (``_celt_imdct_bucket``), and the pitch postfilter and
    deemphasis (data-dependent IIRs) finish on the host in C."""
    stats = ctx.stats
    B = len(decs)
    lane_frames = [[(fr, pk) for pk in _packets(d, "celt")
                    for fr in pk["frames"]] for d in decs]
    n_steps = max(len(f) for f in lane_frames)
    outputs = [[] for _ in range(B)]
    for step in range(n_steps):
        reqs, lanes = [], []
        with stats.stage("parse", "opus", cpu=True):
            for bi, d in enumerate(decs):
                if step >= len(lane_frames[bi]):
                    continue
                fr, pk = lane_frames[bi][step]
                cd = d._streams[0]._celt
                n = pk["frame_size"]
                if len(fr) == 0:
                    outputs[bi].append(
                        np.zeros((n, d.channels), np.float32))
                    continue
                endband = [13, 17, 19, 21][(pk["config"] - 16) >> 2]
                reqs.append((cd, cd.decode_frame_symbols(
                    RangeDecoder(fr), 2 if pk["stereo"] else 1, n, 0,
                    endband)))
                lanes.append((bi, d, n))
        if not reqs:
            continue
        with stats.stage("enqueue", "opus"):
            for (bi, d, n), (cd, _), raw in zip(
                    lanes, reqs, _synthesize(stats, ctx.device, reqs)):
                outputs[bi].append(
                    _gained(d, cd.apply_raw(*raw, n)).astype(np.float32))
    return _lane_pcm(decs, outputs)


def _silk_upsample_step(stats: Stats, rs, X, out_max: int) -> np.ndarray:
    """One packet step of a SILK or hybrid group's upsample: every row
    of X [rows, T] through `rs` (one upload, one K13 launch, one
    download).  Returns the [rows, n] float32 48 kHz samples."""
    h0, d0 = rs.h2d_bytes, rs.d2h_bytes
    Y = rs.process(X, out_max)
    nb = rs.h2d_bytes - h0
    if nb:
        stats.window("opus_silk", nb, h2d_fmt="opus")
        stats.add("d2h_bytes", rs.d2h_bytes - d0)
    return Y


def _drain_rows(d, rs, bi, out, owed, sd=None):
    """EOS of lane bi of a SILK or hybrid group: drain its upsampler
    rows' tail (flush_row) into `out` now, before later steps zero-feed
    its rows, as the per-stream read drains at its end: as many samples
    as the stream's length still wants, at most the `owed` ones (the
    samples the upsampler holds back, or a hybrid lane's CELT delay
    FIFO if longer; never the granule field alone), padded with zeros
    to that count.  For a hybrid lane (its stream decoder `sd`), the
    FIFO and the unfinished redundancy fade join the tail, as in the
    per-stream read's drain_tail."""
    nch = d.channels
    want = min(d.preskip + d.length_frames - sum(o.shape[0] for o in out),
               owed)
    if want <= 0:
        return
    tail = np.stack([rs.flush_row(bi * nch + c, want)
                     for c in range(nch)], 1).astype(np.float32)
    if sd is not None:
        hd = sd._celt_hyb_delay
        if hd.shape[0]:
            m = min(tail.shape[0], hd.shape[0])
            tail[:m] += hd[:m, :nch]
            sd._celt_hyb_delay = hd[:0]
        sd._apply_red_carry(tail)
    if tail.shape[0] < want:
        tail = np.pad(tail, ((0, want - tail.shape[0]), (0, 0)))
    out.append(_gained(d, tail))


def _lane_pcm(decs, outs):
    """Each lane's PCM: its steps' outputs, preskip and length
    applied."""
    result = []
    for bi, d in enumerate(decs):
        pcm = np.concatenate(outs[bi]) if outs[bi] else \
            np.zeros((0, d.channels), np.float32)
        pcm = pcm[d.preskip:]
        if d.length_frames:
            pcm = pcm[: d.length_frames]
        result.append(pcm)
    return result


def decode_silk(ctx: GroupContext, decs: List[OpusDecoder], key):
    """SILK lockstep (the JAX package's batch.py:3247): each lane's
    SILK synthesis at the native rate on the host (the per-stream
    read's SilkDecoder), then one K13 launch a packet step upsamples
    every lane to 48 kHz.  A lane that ends drains its resampler tail
    at once (flush_row), before later steps zero-feed its rows, as the
    per-stream read drains at EOS."""
    nch, config, stereo, nfr = key
    stats = ctx.stats
    B = len(decs)
    pkts = [_packets(d, "silk") for d in decs]
    bw = config // 4
    dur_ms = [10, 20, 40, 60][config & 3]
    frame48 = dur_ms * 48 * nfr
    T = dur_ms * [8, 12, 16][bw] * nfr
    coded = 2 if stereo else 1
    # one warm-up a bandwidth whatever the channel count
    # (models/silk.py: the mono copy and the MS unmix share a
    # one-sample-delay timeline)
    rs = BatchedFittedUpsampler(bw, B * nch, feed=[4, 9, 12][bw],
                                device=ctx.device)
    silks = [SilkDecoder(output_channels=nch) for _ in decs]
    outs = [[] for _ in range(B)]
    owed = [0] * B   # each lane's samples the upsampler holds back
    stats.add("opus_silk_lanes", B)
    for s in range(max(len(p) for p in pkts)):
        X = np.zeros((B * nch, T), np.float32)
        with stats.stage("parse", "opus", cpu=True):
            for bi in range(B):
                if s >= len(pkts[bi]):
                    continue
                cols = []
                for fr in pkts[bi][s]["frames"]:
                    rd = RangeDecoder(fr)
                    cols.append(silks[bi].decode_superframe(
                        rd, bw, coded, dur_ms))
                    if rd.tell() + 17 <= len(fr) * 8:
                        # an unread tail is a mode-transition CELT
                        # redundancy frame: the group cannot splice its
                        # fade at the native rate, so the lane is demoted
                        # to the per-stream read
                        raise AudioFormatError(
                            "Opus: SILK redundancy tail in group")
                X[bi * nch: (bi + 1) * nch] = \
                    np.concatenate(cols, axis=0).T[:, :T]
        with stats.stage("enqueue", "opus"):
            Y = _silk_upsample_step(stats, rs, X, frame48)
        for bi, d in enumerate(decs):
            if s >= len(pkts[bi]):
                continue
            pcm = np.ascontiguousarray(Y[bi * nch: (bi + 1) * nch].T)
            outs[bi].append(_gained(d, pcm))
            owed[bi] += frame48 - pcm.shape[0]
            if s == len(pkts[bi]) - 1:
                _drain_rows(d, rs, bi, outs[bi], owed[bi])
    return _lane_pcm(decs, outs)


def decode_hybrid(ctx: GroupContext, decs: List[OpusDecoder], key):
    """Hybrid lockstep (the JAX package's batch.py:3079), a step in
    three phases.  On the host, each lane's SILK superframe at 16 kHz,
    its redundancy flag and its CELT symbols (bands 17 on, on the same
    range decoder).  On the device, one K13 launch upsamples every
    lane's SILK block and the CELT spectra run the bucketed IMDCT and
    K12a (``_celt_imdct_bucket``).  On the host again, the postfilter
    and deemphasis (apply_raw), the CELT delay FIFO and the redundancy
    paste and fade: the per-stream read's own methods.  Each lane's
    SILK delay count lives in this call, keyed by lane, so a retry
    after a demotion starts from zero with its fresh decoder."""
    nch, config, stereo = key
    stats = ctx.stats
    B = len(decs)
    pkts = [_packets(d, "hybrid") for d in decs]
    dur_ms = 20 if config & 1 else 10    # configs 12-15: 10 or 20 ms
    frame48 = dur_ms * 48
    T = dur_ms * 16                      # SILK runs wideband
    coded = 2 if stereo else 1
    endband = 19 if config < 14 else 21
    rs = BatchedFittedUpsampler(2, B * nch, feed=12, device=ctx.device)
    sds = []
    for d in decs:
        sd = d._streams[0]
        if sd._silk is None:
            sd._silk = SilkDecoder(output_channels=nch)
        sds.append(sd)
    delayed = [0] * B
    outs = [[] for _ in range(B)]
    stats.add("opus_hybrid_lanes", B)
    for st in range(max(len(p) for p in pkts)):
        X = np.zeros((B * nch, T), np.float32)
        stash = {}
        with stats.stage("parse", "opus", cpu=True):
            for bi in range(B):
                if st >= len(pkts[bi]):
                    continue
                sd = sds[bi]
                frame = pkts[bi][st]["frames"][0]
                rd = RangeDecoder(frame)
                native = sd._silk.decode_superframe(rd, 2, coded, dur_ms)
                X[bi * nch: (bi + 1) * nch] = native.T[:, :T]
                # redundancy flag and size (dopus.d:6400-6420)
                size = len(frame)
                redundancy = redundancy_pos = 0
                red = None
                if rd.tell() + 37 <= size * 8:
                    redundancy = rd.dec_bit_logp(12)
                if redundancy:
                    redundancy_pos = rd.dec_bit_logp(1)
                    size -= rd.dec_uint(256) + 2
                    if size < 0:
                        raise AudioFormatError("Opus: bad redundancy size")
                    rd.rebound_end(size)
                    if redundancy_pos:
                        sd._celt.flush()
                        red = sd._decode_red_frame(frame[size:], coded, 2)
                params = sd._celt.decode_frame_symbols(
                    rd, coded, frame48, 17, endband)
                stash[bi] = (params, redundancy, red, frame, size)
        if not stash:
            break
        with stats.stage("enqueue", "opus"):
            Y = _silk_upsample_step(stats, rs, X, frame48)
            raws = dict(zip(stash, _synthesize(stats, ctx.device, [
                (sds[bi]._celt, stash[bi][0]) for bi in stash])))
        for bi, (params, redundancy, red, frame, size) in stash.items():
            d, sd = decs[bi], sds[bi]
            pcm = np.ascontiguousarray(Y[bi * nch: (bi + 1) * nch].T)
            before = delayed[bi]
            delayed[bi] += frame48 - pcm.shape[0]
            celt_pcm = sd._celt.apply_raw(*raws[bi], frame48).astype(
                np.float32)
            # the CELT delay FIFO (dopus.d:6424-6466)
            comb = np.concatenate([sd._celt_hyb_delay, celt_pcm])
            n = pcm.shape[0]
            pcm = pcm + comb[:n, : pcm.shape[1]]
            sd._celt_hyb_delay = comb[n:]
            sd._apply_red_carry(pcm)
            if red is not None:   # redundancy at the frame's start
                sd._paste_red_start(pcm, red, before)
            elif redundancy:
                sd._celt.flush()
                sd._fade_red_tail(
                    pcm, sd._decode_red_frame(frame[size:], coded, 2),
                    before)
            outs[bi].append(_gained(d, pcm))
            if st == len(pkts[bi]) - 1:
                _drain_rows(d, rs, bi, outs[bi], max(
                    delayed[bi], sd._celt_hyb_delay.shape[0]), sd)
    return _lane_pcm(decs, outs)


def decode_mixed(ctx: GroupContext, decs: List[OpusDecoder], key):
    """Mode-switching Opus lockstep (the JAX package's batch.py:2874):
    every lane drives the per-stream read's own packet generator
    (models/opus.py ``decode_packet_gen``), so SILK synthesis,
    resampler flushes, redundancy fades and the hybrid delay FIFO are
    the per-stream read's by construction.  Only the full CELT
    syntheses are answered here: from OPUS_MIXED_DEVICE_MIN_LANES
    lanes on, bucketed by (blocks, blocksize) across lanes, one K12a
    launch a bucket a round (``_celt_imdct_bucket``); in a smaller
    group, on the host by ``CeltDecoder.synthesize``, the per-stream
    read's own IMDCT.  Under a mesh the device path runs whatever the
    lane count, as the JAX package's does."""
    stats = ctx.stats
    B = len(decs)
    use_device = ctx.sharded or B >= OPUS_MIXED_DEVICE_MIN_LANES
    pkts = [_packets(d, "mixed") for d in decs]
    outs = [[] for _ in range(B)]
    gens = [None] * B     # each lane's live decode_packet_gen
    nexts = [0] * B       # each lane's next packet
    sends = [None] * B    # each lane's pending synthesis answer
    sds = [d._streams[0] for d in decs]
    done = [False] * B
    stats.add("opus_mixed_lanes", B)
    while not all(done):
        jobs = []   # (lane, celt_decoder, params) of the round
        with stats.stage("parse", "opus", cpu=True):
            for bi, d in enumerate(decs):
                while not done[bi]:
                    if gens[bi] is None:
                        if nexts[bi] >= len(pkts[bi]):
                            done[bi] = True
                            break
                        gens[bi] = sds[bi].decode_packet_gen(
                            pkts[bi][nexts[bi]])
                        nexts[bi] += 1
                        sends[bi] = None
                    try:
                        cd, params = gens[bi].send(sends[bi])
                    except StopIteration as e:
                        outs[bi].append(_gained(d, e.value))
                        gens[bi] = sends[bi] = None
                        continue
                    jobs.append((bi, cd, params))
                    break
            if jobs and not use_device:
                for bi, cd, p in jobs:
                    sends[bi] = cd.synthesize(p)
                stats.add("opus_mixed_host_rounds", 1)
        if not jobs or not use_device:
            continue
        with stats.stage("enqueue", "opus"):
            for (bi, cd, p), raw in zip(jobs, _synthesize(
                    stats, ctx.device, [(cd, p) for _, cd, p in jobs])):
                sends[bi] = cd.apply_raw(*raw, p["frame_size"])
    for bi, d in enumerate(decs):
        sd = sds[bi]
        total = sum(o.shape[0] for o in outs[bi])
        # the EOS drain of the resampler tail, the hybrid FIFO and the
        # redundancy carry, bounded by what the lane owes (never the
        # granule field alone), as the per-stream read
        want = min(d.preskip + d.length_frames - total,
                   max(sd._delayed, sd._celt_hyb_delay.shape[0]))
        if want > 0 and sd._silk_rs is not None:
            tail = sd.drain_tail(want)
            if tail.shape[0] < want:
                tail = np.pad(tail, ((0, want - tail.shape[0]), (0, 0)))
            outs[bi].append(_gained(d, tail))
    return _lane_pcm(decs, outs)
