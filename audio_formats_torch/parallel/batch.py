"""BatchDecoder — batched lockstep decode with PyTorch device stages.

N independent compressed streams decode in lockstep.  FLAC: the host
entropy stage (the C library in host/src/af_host.cc) parses a *window* of W
frames per stream, and ONE upload plus one chain of device work runs per
window: packed residual unpack → LPC kernel → stereo decorrelation.  QOA:
every frame carries its LMS state, so every (frame, channel) of a group is
an independent lane, and one upload plus one LMS decode kernel runs per
window of lanes.  The PCM windows stay on the device with
``decode_all(output="device")``.

The port decodes FLAC, Ogg-FLAC and QOA so far; every other lane carries an
error that names its format.

Error lattice: a corrupt stream only poisons its own lane — it stops
producing frames and its `errors` entry is set; other lanes are unaffected.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import models
from ..errors import AudioFormatError
from ..host import native as _native
from ..io.source import ByteSource, FileSource, MemorySource
from ..models.flac import FlacDecoder, device_of
from ..models.qoa import _F32_RECIP, QoaDecoder
from ..ops import lms as lms_ops
from ..ops import lpc as lpc_ops

#: FLAC frames per device call
FLAC_WINDOW_FRAMES = 12
#: QOA (frame, channel) lanes per device call (bounds upload and memory)
QOA_WINDOW_LANES = 8192

#: FLAC packed-residual width buckets
_FLAC_W_BUCKETS = (4, 6, 8, 10, 12, 14, 17, 20, 26, 32)
#: overflow plane row buckets for _flac_width_plan
_FLAC_OVF_BUCKETS = (128, 512, 2048)


def _flac_width_plan(w_l, wmax: int, Ln: int, bs: int):
    """Pick the packed residual width for a FLAC window: (wb, Lb).

    Lb == 0: every row packs at wb (the max-width bucket, the plain
    layout).  Lb > 0: rows pack at the smaller wb and the few rows wider
    than wb ship in a separate [Lb, bs] plane (flac_merge_overflow).
    Minimizes uploaded words over the bucket grid."""
    def stride(w):
        return (bs * w + 31) // 32 + 1

    wb_plain = next((x for x in _FLAC_W_BUCKETS if wmax <= x), 32)
    plans = [(Ln * stride(wb_plain), wb_plain, 0)]
    for ws in _FLAC_W_BUCKETS:
        if ws >= wb_plain:
            break
        nov = int(np.count_nonzero(w_l > ws))
        for lb in _FLAC_OVF_BUCKETS:
            if nov + 1 <= lb:
                plans.append(
                    (Ln * stride(ws) + lb * stride(wb_plain), ws, lb))
                break
    _, wb, lb = min(plans)
    return wb, lb


class _HostCopy:
    """A device→host PCM copy in flight: a pinned host tensor and the
    event recorded after its copy was enqueued."""

    def __init__(self, dev_tensor: torch.Tensor):
        self.host = torch.empty(dev_tensor.shape, dtype=dev_tensor.dtype,
                                pin_memory=True)
        self.host.copy_(dev_tensor, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(dev_tensor.device))

    def numpy(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def _prefetch(out: torch.Tensor, to_device: bool):
    """Start the device→host PCM copy without blocking, ONLY when the
    caller will download it: with output="device" the PCM stays put."""
    if to_device or not out.is_cuda:
        return out
    return _HostCopy(out)


def _to_numpy(out) -> np.ndarray:
    if isinstance(out, _HostCopy):
        return out.numpy()
    return out.cpu().numpy()


def _open_source(item) -> ByteSource:
    if isinstance(item, (bytes, bytearray, memoryview)):
        return MemorySource(item)
    return FileSource(item)


def _upload(device: torch.device, *arrays):
    """Window arrays → tensors on `device` (uint32 words travel as int32
    bits).  A synchronous copy: the host buffer may be reused at once."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)


def _lane_chunks(lanes, n_workers):
    """Contiguous lane chunks for the parse pool: ~4 chunks per worker
    rides out variable per-lane parse cost without paying per-lane task
    dispatch overhead.  Order-preserving so chunked results zip back
    against the live-lane list."""
    n = max(1, -(-len(lanes) // max(1, n_workers * 4)))
    return [lanes[i: i + n] for i in range(0, len(lanes), n)]


class _PendingGroup:
    """A lockstep group whose PCM windows are still on the device.
    ``finalize()`` downloads and assembles the per-lane numpy PCM (cached)."""

    def __init__(self, kind, decs, pending, fin, args):
        self.kind = kind
        self.decs = decs
        self.pending = pending
        self._fin = fin
        self._args = args
        self._result = None

    def seconds(self) -> float:
        # QOA decoders count decoded frames in _pos, FLAC in _frame_pos
        pos = "_pos" if self.kind == "qoa" else "_frame_pos"
        return sum(getattr(d, pos) / max(1, d.sample_rate) for d in self.decs)

    def finalize(self):
        if self._result is None:
            self._result = self._fin(*self._args)
        return self._result


class DeviceBatchResult:
    """Result of ``BatchDecoder.decode_all(output="device")``: decoded PCM
    window tensors stay on the decoder's device.

    * ``windows()`` — the window tensors per group (window-major layout)
    * ``sync()`` — block until the device has finished every window
    * ``to_numpy()`` — download everything; identical to output="numpy"
    """

    def __init__(self, owner, out, finalizers):
        self._owner = owner
        self._out = out
        self._finalizers = finalizers
        for _, g in finalizers:
            owner._note_seconds(g.kind, g.seconds())
        for i, v in enumerate(out):
            if isinstance(v, np.ndarray) and owner.decoders[i] is not None:
                owner._note_seconds(
                    type(owner.decoders[i]).__name__.replace("Decoder", "").lower(),
                    v.shape[0] / max(1, owner.decoders[i].sample_rate),
                )

    def windows(self):
        return [
            (g.kind, [p[0] for p in g.pending]) for _, g in self._finalizers
        ]

    def sync(self):
        """Block until the device has finished all of this batch's work."""
        if self._owner.device.type == "cuda":
            torch.cuda.synchronize(self._owner.device)
        return self

    def to_numpy(self):
        out = list(self._out)
        for chunk, g in self._finalizers:
            res = g.finalize()
            for i, pcm in zip(chunk, res):
                out[i] = pcm
        return out


class BatchDecoder:
    """Decode a batch of streams on one torch device.

    Usage::

        dec = BatchDecoder([b1, b2, path3, ...], device="cuda")
        pcm_list = dec.decode_all()       # list of (frames, ch) float32
        dec.stats                         # decoded seconds, per-lane errors

    ``device`` is where the device stages run: "cuda" (the default) raises
    when there is no GPU; "cpu" runs every stage's plain PyTorch version.
    """

    def __init__(self, items: Sequence, device="cuda"):
        self.device = device_of(device)
        self.decoders: List[Optional[object]] = []
        self.errors: List[Optional[str]] = []
        for item in items:
            try:
                src = _open_source(item)
                dec = models.probe_all(src, self.device)
                if dec is None:
                    raise AudioFormatError(
                        "Cannot decode stream: unrecognized encoding."
                    )
                self.decoders.append(dec)
                self.errors.append(None)
            except AudioFormatError as e:
                self.decoders.append(None)
                self.errors.append(e.message)
        self._stats_lock = threading.Lock()
        self.stats = {
            "decoded_seconds": 0.0,
            "decoded_seconds_by_format": {},
            "lanes": len(items),
            # per-stage split: host entropy parse ms, device enqueue
            # (upload+dispatch) ms, PCM fetch ms, bytes to and from the
            # device, device windows issued.  The wall counters sum the
            # walls of groups that run concurrently, so they can exceed
            # the batch wall; host_cpu_ms is the thread-CPU sum.
            "host_ms": 0.0,
            "enqueue_ms": 0.0,
            "fetch_ms": 0.0,
            "host_ms_by_format": {},
            "enqueue_ms_by_format": {},
            "host_cpu_ms": 0.0,
            "host_cpu_ms_by_format": {},
            "h2d_bytes": 0,
            "h2d_bytes_by_format": {},
            "d2h_bytes": 0,
            "windows": 0,
            "group_demotions": 0,
        }

    def _stat_add(self, key: str, val, fmt: str = None):
        """Thread-safe stats accumulation: groups may decode concurrently,
        and a bare ``+=`` on a dict entry is a read-modify-write race."""
        with self._stats_lock:
            if fmt is None:
                self.stats[key] = self.stats.get(key, 0) + val
            else:
                by = self.stats[key]
                by[fmt] = by.get(fmt, 0.0) + val

    def _note_seconds(self, fmt: str, seconds: float):
        self._stat_add("decoded_seconds", seconds)
        self._stat_add("decoded_seconds_by_format", seconds, fmt=fmt)

    def _note_stage(self, key: str, fmt: str, t0: float):
        """Close a stage wall timer opened at ``t0`` (host_ms / enqueue_ms
        and its per-format split)."""
        dt = (time.perf_counter() - t0) * 1e3
        self._stat_add(key, dt)
        self._stat_add(key + "_by_format", dt, fmt=fmt)

    def _note_host_cpu(self, fmt: str, cpu_t0: float):
        """Thread-CPU accumulation for host stages that run on a parse
        pool (each worker measures its own thread)."""
        cdt = (time.thread_time() - cpu_t0) * 1e3
        self._stat_add("host_cpu_ms", cdt)
        self._stat_add("host_cpu_ms_by_format", cdt, fmt=fmt)

    def _reprobe(self, i):
        """Fresh decoder for lane i (a failed grouped run leaves decoder
        state mid-window); sets the lane error when the re-probe fails."""
        d = self.decoders[i]
        try:
            src = getattr(d, "_src", None)
            self.decoders[i] = (
                models.probe_all(src, self.device) if src is not None
                else None
            )
        except Exception:
            self.decoders[i] = None
        if self.decoders[i] is None and self.errors[i] is None:
            self.errors[i] = "Cannot decode stream: data is corrupt."

    def _run_group(self, fn, chunk, *args, to_device: bool = False):
        """Run a lockstep group decode with the error lattice intact: a lane
        that raises inside the grouped device path must not abort the other
        lanes.  Demotion is PER-LANE: on a failure the chunk bisects (each
        half re-probed to fresh decoders, then re-run grouped), so one
        poisoned lane costs O(log G) grouped re-runs while the innocent
        lanes stay on the device path.  Only a failing single-lane chunk
        leaves the grouped path (stats["lanes_demoted"]); the per-stream
        loop then decodes it with its own error handling.  The exception
        is recorded in stats["group_exceptions"] so code faults don't
        masquerade as corrupt data."""
        try:
            return fn([self.decoders[i] for i in chunk], *args,
                      to_device=to_device)
        except Exception as e:
            self._stat_add("group_demotions", 1)
            with self._stats_lock:
                excs = self.stats.setdefault("group_exceptions", [])
                if len(excs) < 32:
                    excs.append(f"{type(e).__name__}: {e}")
            if len(chunk) == 1:
                self._stat_add("lanes_demoted", 1)
                self._reprobe(chunk[0])
                return [None]
            mid = len(chunk) // 2
            out = []
            for half in (chunk[:mid], chunk[mid:]):
                for i in half:
                    self._reprobe(i)
                live = [i for i in half if self.decoders[i] is not None]
                res = {i: None for i in half}
                if live:
                    sub = self._run_group(fn, live, *args,
                                          to_device=to_device)
                    if isinstance(sub, _PendingGroup):
                        sub = sub.finalize()
                    res.update(zip(live, sub))
                out.extend(res[i] for i in half)
            return out

    # ------------------------------------------------------------------ API
    def decode_all(self, output: str = "numpy"):
        """Decode every stream to completion.

        output="numpy" (default): returns per-lane PCM arrays (None for
        errored lanes) — every sample crosses back to the host.

        output="device": PCM stays on the device.  Returns a
        :class:`DeviceBatchResult`; call ``.sync()`` to block until all
        device work is done, ``.to_numpy()`` to download and get exactly
        the output="numpy" result.
        """
        to_device = output == "device"
        out: List[Optional[object]] = [None] * len(self.decoders)
        finalizers = []

        flac_groups = {}
        qoa_groups = {}
        for i, d in enumerate(self.decoders):
            if isinstance(d, FlacDecoder):
                # >16 bps lanes ride the exact LPC lanes and the full-width
                # output; frames beyond 18 bits take the host path per frame
                # inside the group
                flac_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, QoaDecoder):
                qoa_groups.setdefault(d.channels, []).append(i)

        # lockstep group width: with device-resident output the whole batch
        # can ride one group (no per-window PCM download); when PCM is
        # downloaded, moderate groups let fetches overlap the next group's
        # host stage
        GROUP = 1024 if to_device else 256

        def run(chunk, fn, *args):
            res = self._run_group(fn, chunk, *args, to_device=to_device)
            if isinstance(res, _PendingGroup):
                finalizers.append((chunk, res))
                for i in chunk:
                    out[i] = res  # placeholder: resolved by to_numpy()
            else:
                for i, pcm in zip(chunk, res):
                    out[i] = pcm

        jobs = []
        for nch, lanes in flac_groups.items():
            for c in range(0, len(lanes), GROUP):
                jobs.append((lanes[c: c + GROUP], self._decode_flac_group,
                             (nch,)))
        for nch, lanes in qoa_groups.items():
            for c in range(0, len(lanes), GROUP):
                jobs.append((lanes[c: c + GROUP], self._decode_qoa_group,
                             (nch,)))
        # groups run concurrently on multi-core hosts (lane sets are
        # disjoint; stats ride _stat_add's lock): one group's host parse
        # overlaps another group's uploads and device windows
        conc = 2 if (os.cpu_count() or 1) > 1 else 1
        if conc > 1 and len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=conc) as ex:
                for f in [ex.submit(run, chunk, fn, *args)
                          for chunk, fn, args in jobs]:
                    f.result()
        else:
            for chunk, fn, args in jobs:
                run(chunk, fn, *args)

        # demoted lanes: per-stream streaming read
        for i, d in enumerate(self.decoders):
            if d is None or out[i] is not None:
                continue
            try:
                chunks = []
                while True:
                    c = d.read(1 << 16)
                    if c.shape[0] == 0:
                        break
                    chunks.append(c)
                out[i] = (
                    np.concatenate(chunks)
                    if chunks
                    else np.zeros((0, d.channels), np.float32)
                )
            except AudioFormatError as e:
                self.errors[i] = e.message

        if to_device:
            return DeviceBatchResult(self, out, finalizers)
        for i, pcm in enumerate(out):
            if pcm is not None and self.decoders[i] is not None:
                self._note_seconds(
                    type(self.decoders[i]).__name__.replace("Decoder", "").lower(),
                    pcm.shape[0] / max(1, self.decoders[i].sample_rate),
                )
        return out

    # ------------------------------------------------ batched FLAC lockstep
    def _decode_flac_group(self, decs: List[FlacDecoder], nch: int,
                           to_device: bool = False):
        """FLAC lockstep over the packed wire: the C host stage Rice-decodes
        W frames per lane, packs the residual rows at the window's bit
        width, and one upload plus one device chain (unpack → overflow
        merge → LPC kernel → stereo decorrelation) runs per window."""
        B = len(decs)
        W = FLAC_WINDOW_FRAMES
        device = self.device
        outputs = [[] for _ in range(B)]
        active = np.ones(B, dtype=bool)
        pending = []  # (device out32, [(slot, si, blocksize), ...])

        # one dispatch worker: window t+1's host parse overlaps window t's
        # pack, upload and device chain
        pool = ThreadPoolExecutor(max_workers=1)
        n_workers = max(1, min(8, (os.cpu_count() or 1)))
        parse_pool = ThreadPoolExecutor(max_workers=n_workers) \
            if n_workers > 1 else None

        parse_lib = _native.get_lib()

        def _host_frame(d, bi, bs, ca, residual, coeffs, order, shift,
                        wasted):
            # beyond the 18-bit range of the device lanes: exact int64 on
            # the host
            samples = lpc_ops.flac_lpc_np(
                residual, coeffs, order, shift
            ).astype(np.int32)
            out32 = lpc_ops.flac_post_stereo(
                torch.from_numpy(samples), int(ca),
                torch.from_numpy(np.ascontiguousarray(wasted, np.int32)),
                32 - d.bits_per_sample).numpy()
            outputs[bi].append(out32.T)

        # multi-lane C surface (af_flac_parse_window_multi): one C call
        # Rice-decodes a whole lane chunk into [B, W*ch, mb_g] batch rows.
        # Requires a uniform streaminfo max_block across the group (it
        # doubles as the C parser's validation bound and row stride) and a
        # bounded parse buffer; otherwise the per-lane path below runs.
        mb_vals = {d._max_block if 0 < d._max_block <= 65535 else 65535
                   for d in decs}
        mb_g = mb_vals.pop() if len(mb_vals) == 1 else 0
        fmulti = (parse_lib is not None
                  and mb_g > 0
                  and all(d.channels == nch for d in decs)
                  and B * W * nch * mb_g * 4 <= (512 << 20))
        if fmulti:
            fkeep = []
            fptrs = np.zeros(B, np.uint64)
            flens = np.zeros(B, np.int64)
            fcb = np.zeros(B, np.int64)
            fbps = np.zeros(B, np.int32)
            for bi, d in enumerate(decs):
                addr, nb2, keep = _native.buf_addr(d._view)
                fkeep.append(keep)
                fptrs[bi] = addr
                flens[bi] = nb2
                fcb[bi] = d._cur_bit
                fbps[bi] = d.bits_per_sample
            res_buf = res_buf_first = np.empty((B, W * nch, mb_g),
                                               np.int32)
            # second residual buffer: the dispatch worker packs straight
            # from these rows (af_flac_pack_gather), so window k's rows
            # must survive until its pack completes while window k+1
            # parses into the OTHER buffer; buf_futs[parity] gates reuse
            # two windows later
            res_buf_alt = np.empty_like(res_buf)
            cf_buf = np.empty((B, W * nch, 32), np.int32)
            ord_buf = np.empty((B, W * nch), np.int32)
            shf_buf = np.empty((B, W * nch), np.int32)
            was_buf = np.empty((B, W * nch), np.int32)
            bpsb_buf = np.empty((B, W * nch), np.int32)
            meta_buf = np.empty((B, W, 4), np.int64)
            nf_buf = np.zeros(B, np.int32)

        def _parse_chunk_fmulti(lanes):
            _ct0 = time.thread_time()
            try:
                gated = []
                for bi in lanes:
                    d = decs[bi]
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                    else:
                        gated.append(bi)
                if gated:
                    _native.flac_parse_window_multi(
                        parse_lib, gated, fptrs, flens, fcb, fbps,
                        nch, mb_g, W, res_buf, cf_buf, ord_buf, shf_buf,
                        was_buf, bpsb_buf, meta_buf, nf_buf)
                gset = set(gated)
                return [_post_lane_fmulti(bi) if bi in gset
                        else ([], False, 0) for bi in lanes]
            finally:
                self._note_host_cpu("flac", _ct0)

        def _take_frames(d, bi, n, meta_l, maxbps, res, cf, orr, sh, wa,
                         bpsr):
            """Walk one lane's parsed frames: wide frames decode on the
            host at once, the others claim an output slot at their parse
            position (so a window mixing both keeps frame order) and join
            the device window."""
            out, prog, mbs = [], False, 0
            dch = d.channels
            capped = False
            for f in range(n):
                if d._frame_pos >= d.length_frames > 0:
                    capped = True
                    break
                bs, ca = meta_l[f][0], meta_l[f][1]
                d._cur_bit = meta_l[f][3]
                rows = slice(f * dch, f * dch + dch)
                prog = True
                if maxbps[f] > 18:
                    _host_frame(d, bi, bs, ca, res[rows, :bs], cf[rows],
                                orr[rows], sh[rows], wa[rows])
                    d._frame_pos += bs
                    continue
                slot = [None]
                outputs[bi].append(slot)
                out.append((bs, ca, res[rows, :bs], cf[rows], orr[rows],
                            sh[rows], wa[rows], bpsr[rows], slot))
                d._frame_pos += bs
                mbs = max(mbs, bs)
            if capped or n < W:
                active[bi] = False
            return out, prog, mbs

        def _post_lane_fmulti(bi):
            """Per-lane pass over the chunk-parsed batch rows (consumed by
            this window's assembly before the next window's parse
            overwrites them)."""
            d = decs[bi]
            n = int(nf_buf[bi])
            if n == 0:
                active[bi] = False
                return [], False, 0
            meta_l = meta_buf[bi, :n].tolist()
            maxbps = bpsb_buf[bi, : n * nch].reshape(n, nch)\
                .max(axis=1).tolist()
            got = _take_frames(d, bi, n, meta_l, maxbps, res_buf[bi],
                               cf_buf[bi], ord_buf[bi], shf_buf[bi],
                               was_buf[bi], bpsb_buf[bi])
            fcb[bi] = d._cur_bit  # the cap may take fewer frames than parsed
            return got

        def _parse_chunk(lanes):
            _ct0 = time.thread_time()
            try:
                return [_parse_lane_inner(bi) for bi in lanes]
            finally:
                self._note_host_cpu("flac", _ct0)

        def _parse_lane_inner(bi):
            # per-lane WINDOW parse — ONE C call decodes up to W frames
            # (the entropy stage releases the GIL, so lanes parse
            # concurrently on multi-core hosts)
            d = decs[bi]
            out, prog, mbs = [], False, 0
            if not active[bi]:
                return out, prog, mbs
            if d._frame_pos >= d.length_frames > 0:
                active[bi] = False
                return out, prog, mbs
            if parse_lib is None:
                # pure-Python parser: per-frame
                for _ in range(W):
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                        break
                    p = d._parse_frame_tensors()
                    if p is None:
                        active[bi] = False
                        break
                    prog = True
                    if int(np.max(p[7])) > 18:
                        _host_frame(d, bi, p[0], p[1], p[2], p[3], p[4],
                                    p[5], p[6])
                        d._frame_pos += p[0]
                        continue
                    slot = [None]
                    outputs[bi].append(slot)
                    out.append(p + (slot,))
                    d._frame_pos += p[0]
                    mbs = max(mbs, p[0])
                return out, prog, mbs
            max_block = d._max_block if 0 < d._max_block <= 65535 else 65535
            dch = d.channels
            n, res, cf, orr, sh, wa, bps, meta = _native.flac_parse_window(
                parse_lib, d._view, d._cur_bit, d.bits_per_sample, dch,
                max_block, W)
            maxbps = bps[: n * dch].reshape(n, dch).max(axis=1).tolist() \
                if n else []
            return _take_frames(d, bi, n, meta[:n].tolist(), maxbps, res,
                                cf, orr, sh, wa, bps)

        def _flac_dispatch(rows, ns, keep, residual, coeffs, order, shift,
                           exact, assigns, wasteds, out_shifts, max_bs, S,
                           use_s16):
            # everything per-window arrives as an argument: the enclosing
            # loop rebinds its locals while this runs.  `rows`/`ns` address
            # the parser's residual rows in place; `keep` holds per-lane
            # parse buffers alive until the pack reads them (fmulti rows
            # live in the double-buffered res_buf, gated by buf_futs).
            Ln = S * nch
            h2d = 0
            if parse_lib is not None:
                _i32p = ctypes.POINTER(ctypes.c_int32)
                _u32p = ctypes.POINTER(ctypes.c_uint32)
                _i64p = ctypes.POINTER(ctypes.c_int64)
                t_pk = time.perf_counter()
                w_l = np.zeros(Ln, np.int32)
                wmax = parse_lib.af_flac_widths_gather(
                    rows.ctypes.data_as(_i64p), Ln, max_bs,
                    ns.ctypes.data_as(_i32p),
                    order.ctypes.data_as(_i32p),
                    w_l.ctypes.data_as(_i32p))
                # residual widths are heavy-tailed (verbatim blocks,
                # high-order partitions): pad every row to the max bucket,
                # or pack small and ship the few wide rows apart
                wb, Lb = _flac_width_plan(w_l, wmax, Ln, max_bs)
                stride = (max_bs * wb + 31) // 32 + 1
                packed = np.empty((Ln, stride), np.uint32)
                warm = np.empty((Ln, 32), np.int32)
                parse_lib.af_flac_pack_gather(
                    rows.ctypes.data_as(_i64p), Ln, max_bs,
                    ns.ctypes.data_as(_i32p),
                    order.ctypes.data_as(_i32p), wb,
                    packed.ctypes.data_as(_u32p), stride,
                    warm.ctypes.data_as(_i32p))
                if Lb:
                    # the wide rows ship packed at the window-max bucket
                    over = np.flatnonzero(w_l > wb)
                    wb2 = next((x for x in _FLAC_W_BUCKETS if wmax <= x), 32)
                    stride2 = (max_bs * wb2 + 31) // 32 + 1
                    order2 = np.full(Lb, max_bs, np.int32)
                    order2[1: 1 + over.size] = order[over]
                    packed2 = np.zeros((Lb, stride2), np.uint32)
                    warm2 = np.zeros((Lb, 32), np.int32)
                    if over.size:
                        rows_o = np.ascontiguousarray(rows[over])
                        ns_o = np.ascontiguousarray(ns[over])
                        parse_lib.af_flac_pack_gather(
                            rows_o.ctypes.data_as(_i64p),
                            int(over.size), max_bs,
                            ns_o.ctypes.data_as(_i32p),
                            np.ascontiguousarray(order[over])
                            .ctypes.data_as(_i32p), wb2,
                            packed2[1:].ctypes.data_as(_u32p),
                            stride2,
                            warm2[1:].ctypes.data_as(_i32p))
                    ovf_idx = np.zeros(Ln, np.int32)
                    ovf_idx[over] = np.arange(1, 1 + over.size)
                keep = None   # parser rows consumed
                # runs on the dispatch worker, overlapped with the next
                # window's parse — attribution, not wall split
                self._stat_add("enq_flacp_pack_ms",
                               (time.perf_counter() - t_pk) * 1e3)
                (packed_d, warm_d, coeffs, order_d, shift, exact, assigns,
                 wasteds, out_shifts) = _upload(
                    device, packed, warm, coeffs, order, shift, exact,
                    assigns, wasteds, out_shifts)
                residual_d = lpc_ops.flac_unpack_residuals(
                    packed_d, warm_d, order_d, w=wb, n=max_bs)
                h2d += packed.nbytes + warm.nbytes
                if Lb:
                    p2_d, w2_d, o2_d, idx_d = _upload(
                        device, packed2, warm2, order2, ovf_idx)
                    res_o = lpc_ops.flac_unpack_residuals(
                        p2_d, w2_d, o2_d, w=wb2, n=max_bs)
                    residual_d = lpc_ops.flac_merge_overflow(
                        residual_d, res_o, idx_d)
                    h2d += (packed2.nbytes + warm2.nbytes
                            + order2.nbytes + ovf_idx.nbytes)
            else:
                (residual_d, coeffs, order_d, shift, exact, assigns,
                 wasteds, out_shifts) = _upload(
                    device, residual, coeffs, order, shift, exact,
                    assigns, wasteds, out_shifts)
                h2d += residual.nbytes
            samples = lpc_ops.flac_lpc(
                residual_d, coeffs, order_d, shift, exact
            ).reshape(S, nch, max_bs)
            # <=16-bit lanes (out_shift >= 16): ship int16 losslessly to
            # halve the device->host bytes
            post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                else lpc_ops.flac_post_stereo_batch
            out32 = post(samples, assigns, wasteds, out_shifts)
            return _prefetch(out32, to_device), h2d

        try:
            buf_futs = [None, None]   # dispatch future per buffer parity
            wpar = 0
            while active.any():
                if fmulti:
                    # rows of the window that used this buffer (two
                    # windows ago) must be packed before reuse
                    if buf_futs[wpar] is not None:
                        buf_futs[wpar].result()
                    res_buf = res_buf_alt if wpar else res_buf_first
                # host entropy stage: parse up to W frames per stream
                t_host = time.perf_counter()
                live = [bi for bi in range(B) if active[bi]]
                chunk_fn = _parse_chunk_fmulti if fmulti else _parse_chunk
                if parse_pool is not None:
                    res = [r for sub in parse_pool.map(
                        chunk_fn, _lane_chunks(live, n_workers))
                        for r in sub]
                else:
                    res = chunk_fn(live)
                parsed = [[] for _ in range(B)]
                max_bs = 0
                progress = False
                for bi, (lane_out, prog, mbs) in zip(live, res):
                    parsed[bi] = lane_out
                    progress = progress or prog
                    max_bs = max(max_bs, mbs)
                self._note_stage("host_ms", "flac", t_host)
                lanes = [(bi, p) for bi in range(B) for p in parsed[bi]]
                if not lanes:
                    if not progress:
                        break
                    continue
                t_enq = time.perf_counter()
                # bucket the lane count (multiples of 128 past 128) and the
                # block length, so window shapes repeat
                n_l = len(lanes)
                S = max(8, 1 << (n_l - 1).bit_length()) if n_l <= 128 \
                    else -(-n_l // 128) * 128
                max_bs = -(-max_bs // 1024) * 1024
                coeffs = np.zeros((S * nch, 32), np.int32)
                order = np.full(S * nch, max_bs, np.int32)  # pad: pass-through
                shift = np.zeros(S * nch, np.int32)
                exact = np.zeros(S * nch, bool)
                assigns = np.zeros(S, np.int32)
                wasteds = np.zeros((S, nch), np.int32)
                out_shifts = np.zeros(S, np.int32)
                if parse_lib is not None:
                    # no padded residual scatter: the worker packs straight
                    # from the parser's rows (af_flac_pack_gather).
                    # rows[l] = address of that (lane, channel)'s residual
                    # row, ns[l] its valid sample count (reads as 0
                    # beyond); rows left 0 are all-zero padding rows.
                    rows = np.zeros(S * nch, np.int64)
                    ns = np.zeros(S * nch, np.int32)
                    keep = []          # keepalive for per-lane parse bufs
                    residual = None
                else:
                    rows = ns = keep = None
                    residual = np.zeros((S * nch, max_bs), np.int32)
                for si, (bi, p) in enumerate(lanes):
                    bs, ca, res, cf, orr, sh, wa, bps, _slot = p
                    if residual is None:
                        base = res.__array_interface__["data"][0]
                        st0 = res.strides[0]
                        for c in range(nch):
                            rows[si * nch + c] = base + c * st0
                        ns[si * nch: si * nch + nch] = bs
                        keep.append(res)
                    else:
                        residual[si * nch: si * nch + nch, :bs] = res
                    coeffs[si * nch: si * nch + nch] = cf
                    order[si * nch: si * nch + nch] = orr
                    shift[si * nch: si * nch + nch] = sh
                    exact[si * nch: si * nch + nch] = np.asarray(bps) > 16
                    assigns[si] = ca
                    wasteds[si] = wa
                    out_shifts[si] = 32 - decs[bi].bits_per_sample
                use_s16 = all(decs[bi].bits_per_sample <= 16
                              for bi, _ in lanes)
                fut = pool.submit(
                    _flac_dispatch, rows, ns, keep, residual, coeffs,
                    order, shift, exact, assigns, wasteds, out_shifts,
                    max_bs, S, use_s16)
                self._note_stage("enqueue_ms", "flac", t_enq)
                self._stat_add("windows", 1)
                # slots were claimed at parse time, in frame order; p[8] is
                # the frame's slot
                pending.append((fut, [(p[8], si, p[0]) for si, (bi, p)
                                      in enumerate(lanes)]))
                if fmulti:
                    # this window's rows live in res_buf[wpar]; flip
                    # parity so the next window parses the other buffer
                    buf_futs[wpar] = fut
                    wpar ^= 1
        finally:
            # no worker outlives a lane fault mid-window
            pool.shutdown(wait=True)
            if parse_pool is not None:
                parse_pool.shutdown(wait=True)
        resolved = []
        for fut, slots in pending:
            out32, h2d = fut.result()
            self._stat_add("h2d_bytes", h2d)
            self._stat_add("h2d_bytes_by_format", h2d, fmt="flac")
            resolved.append((out32, slots))
        pending[:] = resolved
        group = _PendingGroup("flac", decs, pending,
                              self._flac_finalize,
                              (decs, outputs, pending, nch))
        return group if to_device else group.finalize()

    def _flac_finalize(self, decs, outputs, pending, nch):
        t0 = time.perf_counter()
        for out32, slots in pending:
            arr = _to_numpy(out32)
            self._stat_add("d2h_bytes", arr.nbytes)
            if arr.dtype == np.int16:
                for slot, si, bs in slots:
                    slot[0] = arr[si, :, :bs].T.astype(np.int32) << 16
            else:
                for slot, si, bs in slots:
                    slot[0] = arr[si, :, :bs].T
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)

        result = []
        for bi, d in enumerate(decs):
            if outputs[bi]:
                s32 = np.concatenate(
                    [c[0] if isinstance(c, list) else c for c in outputs[bi]]
                )
            else:
                s32 = np.zeros((0, nch), np.int32)
            if d.length_frames:
                s32 = s32[: d.length_frames]
            pcm = (s32.astype(np.float64) * (1.0 / 2147483647.0)).astype(
                np.float32
            )
            result.append(pcm)
        return result

    # --------------------------------------------------- batched QOA frames
    def _decode_qoa_group(self, decs: List[QoaDecoder], nch: int,
                          to_device: bool = False):
        """QOA batching: LMS state is in-band per frame (qoa.d:488-503), so
        every frame of every stream is an independent lane — the whole
        group decodes as a few large [lanes, 5120] device calls.  Slice
        payloads ship as int8 (3-bit codes, 4-bit scalefactors) and the
        kernel dequantizes them as it decodes."""
        FULL_S = lms_ops.QOA_SLICES_PER_FRAME
        t_host = time.perf_counter()
        ct_host = time.thread_time()
        metas = []   # (stream index, f_samples)
        H, Wt, SF, CD = [], [], [], []
        for bi, d in enumerate(decs):
            pos = d._byte_pos
            got = 0
            while True:
                p = d._parse_frame_at(pos)
                if p is None:
                    break
                h, w, sf, codes, f_samples, f_size = p
                S = sf.shape[1]
                if S < FULL_S:
                    sf = np.pad(sf, ((0, 0), (0, FULL_S - S)))
                    codes = np.pad(codes,
                                   ((0, 0), (0, FULL_S - S), (0, 0)))
                H.append(h)
                Wt.append(w)
                SF.append(sf.astype(np.int8))
                CD.append(codes.astype(np.int8))
                metas.append((bi, f_samples))
                pos += f_size
                got += f_samples
            d._byte_pos = pos
            d._pos += got
        pending = []  # (device out [Lc, 5120] int32 or its host copy, Lc)
        if metas:
            hist = np.concatenate(H)
            wts = np.concatenate(Wt)
            sf8 = np.concatenate(SF)
            cd8 = np.concatenate(CD)
            self._note_stage("host_ms", "qoa", t_host)
            self._note_host_cpu("qoa", ct_host)
            L = hist.shape[0]
            for c0 in range(0, L, QOA_WINDOW_LANES):
                t_enq = time.perf_counter()
                sl = slice(c0, min(L, c0 + QOA_WINDOW_LANES))
                arrays = (hist[sl], wts[sl], sf8[sl], cd8[sl])
                out = lms_ops.decode_slices(*_upload(self.device, *arrays))
                pending.append((_prefetch(out, to_device), sl.stop - c0))
                self._note_stage("enqueue_ms", "qoa", t_enq)
                h2d = sum(a.nbytes for a in arrays)
                self._stat_add("h2d_bytes", h2d)
                self._stat_add("h2d_bytes_by_format", h2d, fmt="qoa")
                self._stat_add("windows", 1)
        group = _PendingGroup("qoa", decs, pending, self._qoa_finalize,
                              (decs, metas, pending, nch))
        return group if to_device else group.finalize()

    def _qoa_finalize(self, decs, metas, pending, nch):
        t0 = time.perf_counter()
        chunks = []
        for out, n in pending:
            arr = _to_numpy(out)[:n]
            self._stat_add("d2h_bytes", arr.nbytes)
            chunks.append(arr)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        outputs = [[] for _ in decs]
        flat = np.concatenate(chunks) if chunks else \
            np.zeros((0, lms_ops.QOA_FRAME_LEN), np.int32)
        for k, (bi, f_samples) in enumerate(metas):
            lanes = flat[k * nch: (k + 1) * nch]
            outputs[bi].append(lanes[:, :f_samples].T.astype(np.int16))
        result = []
        for bi, d in enumerate(decs):
            s16 = (np.concatenate(outputs[bi]) if outputs[bi]
                   else np.zeros((0, nch), np.int16))
            s16 = s16[: d.length_frames]
            # same float conversion as the facade (qoa.d:825-834)
            result.append(s16.astype(np.float32) * _F32_RECIP)
        return result
