"""BatchDecoder — batched lockstep decode with PyTorch device stages.

N independent compressed streams decode in lockstep.  FLAC: the host
entropy stage (the C library in host/src/af_host.cc) parses a *window* of W
frames per stream, and ONE upload plus one chain of device work runs per
window: packed residual unpack → LPC kernel → stereo decorrelation; or,
with ``flac_wire="rice"``, the host only indexes the frames and the device
decodes the raw frame bytes (frame-entropy kernel → LPC kernel → stereo).  MP3
Layer III: the C stage parses a window of frames a stream (side info,
reservoir splice, scalefactors; 24 frames on the CPU, on the card as many as
fill one wave of the Huffman kernel, ``mp3_window_frames``) and ships every
granule-channel's Huffman bits in one
exact-size pool; one device chain a window runs the Huffman kernel,
dequant, stereo mix, reorder and the window DSP (IMDCT, synthesis) with
carried overlap and slot history.  MP3 Layers I/II: the host parses
scalefactor-applied subband slots, one synthesis call a window.  QOA:
every frame carries its LMS state, so every (frame, channel) of a group is
an independent lane, and one upload plus one LMS decode kernel runs per
window of lanes.  WAV: the lanes of one integer sample kind upload their
raw payload bytes as one buffer and one K10 launch turns them into f32.
Ogg Vorbis: the host runs the entropy stage of K packets a lane, and one
upload of the window's spectra plus one device chain (both block sizes'
IMDCT matmuls, then K11's lapped chain with the lap carried on the device)
turns the whole group into PCM.  The PCM windows stay on the device with
``decode_all(output="device")``.  Ogg Opus, CELT-only lanes: the host runs
the symbol stage of one frame a lane, and each (blocks, blocksize) bucket of
the step crosses once, runs K12a (the IMDCT and the overlap-add: one fused
kernel for blocks of 120, the IMDCT matmul and the window mix in place for
long blocks), and comes back once for the postfilter and deemphasis on the
host; so
these lanes return host PCM for either output, as the JAX package's do.
SILK-only lanes of one (config, stereo, frames) shape run their SILK
synthesis on the host a packet a lane, and each packet step upsamples every
lane to 48 kHz in one K13 launch (``ops.resample.BatchedFittedUpsampler``).
Hybrid lanes of one (config, stereo) shape add the CELT layer: its symbols
on the host, its IMDCT buckets through K12a as in the CELT group, and the
delay FIFO and redundancy fades on the host.  Mapping-0 lanes that switch
modes ride the mixed group on a thread of their own: each lane drives the
per-stream read's own packet generator, and the group answers its CELT
synthesis requests in buckets on the device (from
``OPUS_MIXED_DEVICE_MIN_LANES`` lanes) or on the host.  Multistream Opus
lanes take the per-stream read.

MOD and XM lanes, float WAV lanes and multistream Opus lanes take the
per-stream read on the host.  With ``mesh=`` every group chunk splits into
shards over the mesh's 'data' devices, each shard a group of its own on its
device (``parallel/mesh.py``).

Error lattice: a corrupt stream only poisons its own lane — it stops
producing frames and its `errors` entry is set; other lanes are unaffected.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import models, trace
from ..errors import AudioFormatError
from ..host import native as _native
from ..io.source import ByteSource, FileSource, MemorySource
from ..models.flac import FlacDecoder, device_of
from ..models.mp3 import Mp3Decoder
from ..models.opus import OpusDecoder, RangeDecoder
from ..models.opus import parse_packet as _opus_parse
from ..models.qoa import _F32_RECIP, QoaDecoder
from ..models.silk import SilkDecoder
from ..models.vorbis import VorbisDecoder
from ..models.wav import _LINEAR_PCM, WavDecoder
from ..ops import celt_dsp, flac_rice
from ..ops import lms as lms_ops
from ..ops import lpc as lpc_ops
from ..ops import pcm as pcm_ops
from ..ops import vorbis_win
from ..ops.resample import BatchedFittedUpsampler
from ..ops._kernels import KernelError
from ..ops import mp3_dsp, mp3_huff
from .mesh import mesh_device

#: FLAC frames per device call
FLAC_WINDOW_FRAMES = 12
#: MP3 frames per device call: Layers I/II, Layer III on the CPU, and the
#: step Layer III windows on the card are sized in (mp3_window_frames)
MP3_WINDOW_FRAMES = 24
#: QOA (frame, channel) lanes per device call (bounds upload and memory)
QOA_WINDOW_LANES = 8192
#: Vorbis packets a lane per device call
VORBIS_WINDOW_PACKETS = 8
#: the mixed Opus group answers its CELT synthesis requests in buckets on
#: the device from this many lanes on; a smaller group answers them on the
#: host (CeltDecoder.synthesize, the per-stream read's own IMDCT)
OPUS_MIXED_DEVICE_MIN_LANES = 16

#: device-Rice wire: a FLAC group whose streams hold at least this many
#: bytes uploads them once as a corpus and gathers each dispatch's frame pool
#: on the device; a smaller group builds the pool on the host a dispatch
RICE_GATHER_MIN_BYTES = 8 << 20
#: device-Rice wire: pool blocks a dispatch at most (2^30 bits: the kernel's
#: bit cursors are int32)
RICE_DISPATCH_BLOCKS = 524288

#: FLAC packed-residual width buckets
_FLAC_W_BUCKETS = (4, 6, 8, 10, 12, 14, 17, 20, 26, 32)
#: overflow plane row buckets for _flac_width_plan
_FLAC_OVF_BUCKETS = (128, 512, 2048)


def mp3_wave_lanes(device: torch.device) -> int:
    """The Huffman kernel's (K3's) lanes that fill `device` in one wave:
    its SMs x the kernel's resident blocks an SM x its threads a block.
    0 off CUDA, where the plain chain runs."""
    if device.type != "cuda":
        return 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * mp3_huff.HUFF_BLOCKS_PER_SM * mp3_huff.HUFF_THREADS


def mp3_window_frames(lanes_per_frame: int, frames_left: int,
                      wave_lanes: int) -> int:
    """Frames a Layer III device window takes, for a group whose frames
    each hold `lanes_per_frame` granule-channel lanes (B x ngr x nch) and
    whose longest lane has `frames_left` frames.  A window is one K3
    launch and one synthesis product, whose rows are its lanes: the
    window aims at one wave of K3 (`wave_lanes`, mp3_wave_lanes), in
    steps of MP3_WINDOW_FRAMES, then splits the frames evenly over the
    windows that takes, since K14 and the product run every row of a
    window, live or not.  Never below MP3_WINDOW_FRAMES, which it stays
    where a wave holds no more (the CPU, wave_lanes 0; 1,024 stereo
    MPEG-1 lanes)."""
    step = MP3_WINDOW_FRAMES
    wave = max(step, step * (wave_lanes // (step * lanes_per_frame)))
    if frames_left <= 0:
        return step
    n = -(-frames_left // wave)
    return step * -(-frames_left // (step * n))


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


def _flac_host_frame(residual, coeffs, order, shift, chan_assignment,
                     wasted, bps: int) -> np.ndarray:
    """One FLAC frame's channels through exact int64 LPC and the stereo
    stage on the host: [bs, channels] int32, left-justified."""
    samples = lpc_ops.flac_lpc_np(residual, coeffs, order, shift)\
        .astype(np.int32)
    out32 = lpc_ops.flac_post_stereo(
        torch.from_numpy(samples), int(chan_assignment),
        torch.from_numpy(np.ascontiguousarray(wasted, np.int32)),
        32 - bps).numpy()
    return out32.T


def _flac_pcm(decs, outputs, nch):
    """Each FLAC lane's frames, in order, cut to its stream length, as
    float32 PCM."""
    result = []
    for bi, d in enumerate(decs):
        if outputs[bi]:
            s32 = np.concatenate(
                [c[0] if isinstance(c, list) else c for c in outputs[bi]])
        else:
            s32 = np.zeros((0, nch), np.int32)
        if d.length_frames:
            s32 = s32[: d.length_frames]
        result.append((s32.astype(np.float64) * (1.0 / 2147483647.0))
                      .astype(np.float32))
    return result


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


def _format_name(dec) -> str:
    """A decoder's format as stats names it ("mp3", "flac", ...)."""
    return type(dec).__name__.replace("Decoder", "").lower()


def _open_source(item) -> ByteSource:
    if isinstance(item, (bytes, bytearray, memoryview)):
        return MemorySource(item)
    return FileSource(item)


def _upload(device: torch.device, *arrays):
    """Window arrays → tensors on `device` (uint32 words travel as int32
    bits).  On a CUDA device each array is copied into a pinned block of
    torch's caching host allocator (which holds the block until its copy
    has run), then one DMA a block, queued without blocking: CUDA stages a
    pageable copy of megabytes piece by piece while the copy engine waits,
    so its span on the device would cover the host's memcpy.  Either way
    the host buffer may be reused at once."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        src = torch.from_numpy(a)
        if device.type != "cuda":
            out.append(src.to(device))
            continue
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        out.append(host.to(device, non_blocking=True))
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
        if self.kind == "mp3":
            # MP3 decoders count interleaved samples in _cur_sample
            return sum(d._cur_sample / max(1, d.channels)
                       / max(1, d.sample_rate) for d in self.decs)
        # QOA and Vorbis decoders count decoded frames in _pos, FLAC and
        # WAV in _frame_pos
        pos = "_pos" if self.kind in ("qoa", "vorbis") else "_frame_pos"
        return sum(getattr(d, pos) / max(1, d.sample_rate) for d in self.decs)

    def finalize(self):
        if self._result is None:
            self._result = self._fin(*self._args)
        return self._result


def _synchronize(device: torch.device) -> None:
    """Block until `device` has finished its queued work (a no-op off
    CUDA)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceBatchResult:
    """Result of ``BatchDecoder.decode_all(output="device")``: decoded PCM
    window tensors stay on the device of the group (or, under a mesh, the
    shard) that decoded them.

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
                    _format_name(owner.decoders[i]),
                    v.shape[0] / max(1, owner.decoders[i].sample_rate),
                )

    def windows(self):
        return [
            (g.kind, [p[0] for p in g.pending]) for _, g in self._finalizers
        ]

    def sync(self):
        """Block until every device the batch used has finished its work."""
        with trace.root("sync", call=self._owner._trace_call):
            for dev in self._owner.devices_used:
                _synchronize(dev)
        return self

    def to_numpy(self):
        out = list(self._out)
        for chunk, g in self._finalizers:
            res = g.finalize()
            for i, pcm in zip(chunk, res):
                out[i] = pcm
        return out


class BatchDecoder:
    """Decode a batch of streams on one torch device, or over a mesh.

    Usage::

        dec = BatchDecoder([b1, b2, path3, ...], device="cuda")
        pcm_list = dec.decode_all()       # list of (frames, ch) float32
        dec.stats                         # decoded seconds, per-lane errors

    ``device`` is where the device stages run: "cuda" (the default) raises
    when there is no GPU; "cpu" runs every stage's plain PyTorch version.

    ``flac_wire`` is how FLAC crosses to the device: "packed" (the default)
    Rice-decodes on the host and ships residual rows packed at the window's
    width; "rice" ships the raw frame bytes (the host runs only the frame
    sync index) and decodes subframe headers and residuals on the device.
    "rice" needs the C host stage and raises where it did not load.

    ``group_size`` is the lockstep group width: how many lanes of one
    format group share a device window.  None (the default) puts 1024
    lanes in a group with ``output="device"`` and 256 otherwise.

    ``mesh`` (a ``parallel.mesh.Mesh``) shards every lockstep group over
    its 'data' devices: each group chunk splits into ``data`` contiguous
    shards (sized as ``np.array_split`` gives them; an empty one runs
    nothing), and each shard runs as a group of its own on its device, with
    its own windows, pools and carried state (lanes are independent, so the
    output equals the unsharded run's: bit for bit on the integer paths).
    The 'model' column is not used, as the JAX package replicates over it.
    ``device`` then defaults to the mesh's first device, and another one
    raises ValueError.  Lanes outside every group (MOD, XM, float WAV,
    multistream Opus) read on the host as without a mesh; a demoted lane
    reads on its shard's device.
    """

    def __init__(self, items: Sequence, device="cuda", flac_wire="packed",
                 group_size: int = None, mesh=None):
        if mesh is not None:
            device = mesh_device(device, mesh)
        if flac_wire not in ("packed", "rice"):
            raise ValueError(f"flac_wire {flac_wire!r}: want 'packed' or "
                             "'rice'")
        if flac_wire == "rice" and _native.get_lib() is None:
            raise RuntimeError("flac_wire='rice' needs the C host stage "
                               "(host/src/af_host.cc), which did not load")
        self.flac_wire = flac_wire
        self._group_size = group_size
        self.device = device_of(device)
        self.mesh = mesh
        #: the devices the group shards ran on, in first-use order
        self.devices_used: List[torch.device] = []
        self.decoders: List[Optional[object]] = []
        self.errors: List[Optional[str]] = []
        #: the id the tracer gives this decoder's spans (None when off)
        self._trace_call = trace.new_call()
        with trace.root("construct", call=self._trace_call):
            for item in items:
                with trace.span("probe") as sp:
                    try:
                        src = _open_source(item)
                        dec = models.probe_all(src, self.device)
                        if dec is None:
                            raise AudioFormatError(
                                "Cannot decode stream: unrecognized "
                                "encoding.")
                        sp.set(format=_format_name(dec))
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
            # per-stage split: host entropy parse ms; enqueue ms, the
            # group thread's time from a parsed window to its device
            # work handed over (MP3 and packed FLAC: the window's
            # assembly, MP3's pack and the submit to the dispatch worker,
            # whose upload and launch only the tracer's spans time; the
            # other formats: the upload and launch themselves); PCM fetch
            # ms, bytes to and from the device, device windows issued.
            # The wall counters sum the walls of groups that run
            # concurrently, so they can exceed the batch wall;
            # host_cpu_ms is the thread-CPU sum.
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
            "windows_by_format": {},
            # frames a Layer III window took (the largest over the MP3
            # groups; 0 without one)
            "mp3_window_frames": 0,
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
                by[fmt] = by.get(fmt, 0) + val

    def _note_window(self, fmt: str):
        """Count one device window (device call) of format `fmt`."""
        self._stat_add("windows", 1)
        self._stat_add("windows_by_format", 1, fmt=fmt)

    def _note_seconds(self, fmt: str, seconds: float):
        self._stat_add("decoded_seconds", seconds)
        self._stat_add("decoded_seconds_by_format", seconds, fmt=fmt)

    def _note_stage(self, key: str, fmt: str, t: trace.Timer):
        """Stop the stage timer `t` (its span, while the tracer is on) and
        add its wall to `key` (host_ms / enqueue_ms) and its per-format
        split."""
        dt = t.stop().ms
        t.set(format=fmt)
        self._stat_add(key, dt)
        self._stat_add(key + "_by_format", dt, fmt=fmt)

    def _note_host_cpu(self, fmt: str, t: trace.Timer):
        """Stop the stage timer `t`, opened with ``cpu=True`` on this
        thread, and add its thread CPU to host_cpu_ms (a parse pool's
        workers each time their own thread)."""
        cdt = t.stop().cpu_ms
        t.set(format=fmt)
        self._stat_add("host_cpu_ms", cdt)
        self._stat_add("host_cpu_ms_by_format", cdt, fmt=fmt)

    def _reprobe(self, i, device: torch.device):
        """Fresh decoder for lane i on `device`, its shard's (a failed
        grouped run leaves decoder state mid-window); sets the lane error
        when the re-probe fails."""
        d = self.decoders[i]
        try:
            src = getattr(d, "_src", None)
            self.decoders[i] = (
                models.probe_all(src, device) if src is not None
                else None
            )
        except Exception:
            self.decoders[i] = None
        if self.decoders[i] is None and self.errors[i] is None:
            self.errors[i] = "Cannot decode stream: data is corrupt."

    def _run_group(self, fn, chunk, *args, device: torch.device,
                   to_device: bool = False):
        """Run a lockstep group decode with the error lattice intact: a lane
        that raises inside the grouped device path must not abort the other
        lanes.  Demotion is PER-LANE: on a failure the chunk bisects (each
        half re-probed to fresh decoders, then re-run grouped), so one
        poisoned lane costs O(log G) grouped re-runs while the innocent
        lanes stay on the device path.  Only a failing single-lane chunk
        leaves the grouped path (stats["lanes_demoted"]); the per-stream
        loop then decodes it with its own error handling.  The exception
        is recorded in stats["group_exceptions"] so code faults don't
        masquerade as corrupt data.  A KernelError (a kernel that does not
        build, load or launch) is no lane's fault and propagates: demoting
        around it would move the kernel's work to another path.  Every
        call, retries included, runs on the shard's `device`."""
        try:
            return fn([self.decoders[i] for i in chunk], *args,
                      device=device, to_device=to_device)
        except KernelError:
            raise
        except Exception as e:
            self._stat_add("group_demotions", 1)
            with self._stats_lock:
                excs = self.stats.setdefault("group_exceptions", [])
                if len(excs) < 32:
                    excs.append(f"{type(e).__name__}: {e}")
            if len(chunk) == 1:
                self._stat_add("lanes_demoted", 1)
                self._reprobe(chunk[0], device)
                return [None]
            mid = len(chunk) // 2
            out = []
            for half in (chunk[:mid], chunk[mid:]):
                for i in half:
                    self._reprobe(i, device)
                live = [i for i in half if self.decoders[i] is not None]
                res = {i: None for i in half}
                if live:
                    sub = self._run_group(fn, live, *args, device=device,
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
        with trace.root("decode_all", call=self._trace_call):
            return self._decode_all(output)

    def _decode_all(self, output: str):
        to_device = output == "device"
        # the decode_all span, which each group's span names as its
        # parent from whichever thread runs the group
        ctx = trace.context()
        out: List[Optional[object]] = [None] * len(self.decoders)
        finalizers = []

        mp3_groups = {}
        l12_groups = {}
        flac_groups = {}
        qoa_groups = {}
        wav_groups = {}
        vorbis_groups = {}
        opus_groups = {}
        silk_groups = {}
        hybrid_groups = {}
        opus_mixed_groups = {}
        for i, d in enumerate(self.decoders):
            if isinstance(d, Mp3Decoder) and d._layer == 3:
                mp3_groups.setdefault((d.channels, d._mpeg1), []).append(i)
            elif isinstance(d, Mp3Decoder):
                # Layers I/II: no bit reservoir, so frames are independent
                # subband blocks — host parses, one synthesis a window
                l12_groups.setdefault((d.channels, d._layer), []).append(i)
            elif isinstance(d, FlacDecoder):
                # >16 bps lanes ride the exact LPC lanes and the full-width
                # output; frames beyond 18 bits take the host path per frame
                # inside the group
                flac_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, QoaDecoder):
                qoa_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, WavDecoder) and \
                    d._audio_format == _LINEAR_PCM:
                # float WAV lanes take the per-stream read
                wav_groups.setdefault(d.kind, []).append(i)
            elif isinstance(d, VorbisDecoder):
                # the window chain's IMDCT sizes and slopes are the block
                # sizes'
                vorbis_groups.setdefault(
                    (d.channels, d._bs0, d._bs1), []).append(i)
            elif isinstance(d, OpusDecoder) and self._opus_eligible(d):
                opus_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, OpusDecoder) and self._silk_eligible(d):
                pk0 = d._silk_lockstep[0]
                silk_groups.setdefault(
                    (d.channels, pk0["config"], pk0["stereo"],
                     len(pk0["frames"])), []).append(i)
            elif isinstance(d, OpusDecoder) and self._hybrid_eligible(d):
                pk0 = d._silk_lockstep[0]
                hybrid_groups.setdefault(
                    (d.channels, pk0["config"], pk0["stereo"]),
                    []).append(i)
            elif isinstance(d, OpusDecoder) and \
                    self._opus_mixed_eligible(d):
                opus_mixed_groups.setdefault(d.channels, []).append(i)

        # lockstep group width: with device-resident output the whole batch
        # can ride one group (no per-window PCM download); when PCM is
        # downloaded, moderate groups let fetches overlap the next group's
        # host stage
        GROUP = self._group_size or (1024 if to_device else 256)
        data_devices = [self.device] if self.mesh is None \
            else self.mesh.data_devices

        def shards(lanes):
            """(lanes, device) of each non-empty shard of every GROUP chunk
            of `lanes`: a chunk splits into contiguous pieces over the data
            devices."""
            out = []
            for c in range(0, len(lanes), GROUP):
                chunk = lanes[c: c + GROUP]
                for dev, idx in zip(data_devices, np.array_split(
                        np.arange(len(chunk)), len(data_devices))):
                    if idx.size:
                        out.append((chunk[idx[0]: idx[-1] + 1], dev))
            return out

        def run(chunk, device, fn, *args):
            with self._stats_lock:
                if device not in self.devices_used:
                    self.devices_used.append(device)
            with trace.span("group", ctx=ctx, lanes=len(chunk),
                            device=str(device),
                            format=fn.__name__[len("_decode_"):]
                            .replace("_group", "")):
                res = self._run_group(fn, chunk, *args, device=device,
                                      to_device=to_device)
            if isinstance(res, _PendingGroup):
                finalizers.append((chunk, res))
                for i in chunk:
                    out[i] = res  # placeholder: resolved by to_numpy()
            else:
                for i, pcm in zip(chunk, res):
                    out[i] = pcm

        # (lanes, device, group function, its arguments) a shard
        jobs = []
        flac_fn = self._decode_flac_group_rice if self.flac_wire == "rice" \
            else self._decode_flac_group
        for groups, fn, args_of in (
                (mp3_groups, self._decode_mp3_group,
                 lambda k: (k[0], 2 if k[1] else 1)),
                (l12_groups, self._decode_l12_group, lambda k: (k[0],)),
                (flac_groups, flac_fn, lambda k: (k,)),
                (qoa_groups, self._decode_qoa_group, lambda k: (k,)),
                (wav_groups, self._decode_wav_group, lambda k: (k,)),
                (vorbis_groups, self._decode_vorbis_group,
                 lambda k: (k[0],))):
            for key, lanes in groups.items():
                jobs.extend((chunk, dev, fn, args_of(key))
                            for chunk, dev in shards(lanes))
        # the mode-switching Opus group runs on a thread of its own, beside
        # the other groups; it is joined even when another group raises,
        # so no orphaned thread goes on writing `out`, and its own
        # exception is raised here on the main thread
        mixed_thread = None
        mixed_err = []
        if opus_mixed_groups:
            def run_mixed():
                try:
                    for lanes in opus_mixed_groups.values():
                        for chunk, dev in shards(lanes):
                            run(chunk, dev, self._decode_opus_mixed_group)
                except BaseException as e:  # raised on the main thread
                    mixed_err.append(e)

            mixed_thread = threading.Thread(target=run_mixed,
                                            name="af-opus-mixed")
            mixed_thread.start()
        try:
            # groups run concurrently on multi-core hosts (lane sets are
            # disjoint; stats ride _stat_add's lock): one group's host
            # parse overlaps another group's uploads and device windows
            # (under a mesh too: the shards share no collective whose
            # order the threads could break)
            conc = 2 if (os.cpu_count() or 1) > 1 else 1
            if conc > 1 and len(jobs) > 1:
                with ThreadPoolExecutor(max_workers=conc,
                                        thread_name_prefix="af-group") as ex:
                    for f in [ex.submit(run, chunk, dev, fn, *args)
                              for chunk, dev, fn, args in jobs]:
                        f.result()
            else:
                for chunk, dev, fn, args in jobs:
                    run(chunk, dev, fn, *args)
            # the Opus groups after the pooled jobs, a shard after
            # another, as the JAX package runs them: CELT, SILK, hybrid
            for lanes in opus_groups.values():
                for chunk, dev in shards(lanes):
                    run(chunk, dev, self._decode_opus_group)
            for (nch, config, stereo, nfr), lanes in silk_groups.items():
                for chunk, dev in shards(lanes):
                    run(chunk, dev, self._decode_silk_group, nch, config,
                        stereo, nfr)
            for (nch, config, stereo), lanes in hybrid_groups.items():
                for chunk, dev in shards(lanes):
                    run(chunk, dev, self._decode_hybrid_group, nch, config,
                        stereo)
        finally:
            if mixed_thread is not None:
                mixed_thread.join()
        if mixed_err:
            raise mixed_err[0]

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
                    _format_name(self.decoders[i]),
                    pcm.shape[0] / max(1, self.decoders[i].sample_rate),
                )
        return out

    # ------------------------------------------------ batched MP3 lockstep
    def _decode_l12_group(self, decs: List[Mp3Decoder], nch: int,
                          device: torch.device, to_device: bool = False):
        """Layer I/II lockstep: no bit reservoir, so frames are independent
        subband blocks (minimp3.d:286-486).  The host parses W frames per
        lane into scalefactor-applied slot tensors; one batched synthesis
        FIR a window (ops/mp3_dsp.mp3_synth_slots) with carried slot
        history turns the whole group into PCM.  Corrupt frames vanish from
        a lane's slot sequence exactly as in the facade (history kept)."""
        W = MP3_WINDOW_FRAMES
        layer = decs[0]._layer
        spf_slots = 12 if layer == 1 else 36
        TS = W * spf_slots
        B = len(decs)
        shist = torch.zeros((B, nch, 16, 32), dtype=torch.float32,
                            device=device)
        offs = [d._offset for d in decs]
        active = np.ones(B, bool)
        pending = []
        while active.any():
            t_host = trace.timer("parse", cpu=True)
            Sarr = np.zeros((B, nch, TS, 32), np.float32)
            n_slots = np.zeros(B, np.int32)
            for bi, d in enumerate(decs):
                if not active[bi]:
                    continue
                got = 0
                while got < W:
                    if offs[bi] >= len(d._view) - 4:
                        active[bi] = False
                        break
                    S2, fb = d._l12_parse_subbands(offs[bi])
                    if S2 is None:
                        if fb:
                            offs[bi] += fb
                            continue
                        active[bi] = False
                        break
                    offs[bi] += fb
                    Sarr[bi, :, got * spf_slots: got * spf_slots
                         + S2.shape[1]] = S2
                    got += 1
                n_slots[bi] = got * spf_slots
                d._cur_sample += got * d._spf * nch
                d._offset = offs[bi]
            self._note_stage("host_ms", "mp3_l12", t_host)
            self._note_host_cpu("mp3_l12", t_host)
            if not n_slots.any():
                break
            t_enq = trace.timer("enqueue")
            (S_d,) = _upload(device, Sarr)
            pcm, shist = mp3_dsp.mp3_synth_slots(S_d, shist, nch=nch)
            pending.append((_prefetch(pcm, to_device), n_slots))
            self._note_stage("enqueue_ms", "mp3_l12", t_enq)
            self._stat_add("h2d_bytes", Sarr.nbytes)
            self._stat_add("h2d_bytes_by_format", Sarr.nbytes, fmt="mp3_l12")
            self._note_window("mp3_l12")
        group = _PendingGroup("mp3", decs, pending, self._l12_finalize,
                              (decs, pending, nch))
        return group if to_device else group.finalize()

    def _l12_finalize(self, decs, pending, nch):
        t0 = time.perf_counter()
        outs = [[] for _ in decs]
        for pcm, n_slots in pending:
            arr = _to_numpy(pcm)  # [B, nch, TS*32]
            self._stat_add("d2h_bytes", arr.nbytes)
            for bi in range(len(decs)):
                k = int(n_slots[bi]) * 32
                if k:
                    outs[bi].append(arr[bi, :, :k].T)
        result = []
        for bi, d in enumerate(decs):
            full = np.concatenate(outs[bi]) if outs[bi] else \
                np.zeros((0, nch), np.float32)
            full = full[d._start_delay // max(1, nch):]
            if d._total_samples:
                full = full[: d._total_samples // max(1, nch)]
            result.append(np.ascontiguousarray(full, np.float32))
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        return result

    def _decode_mp3_group(self, decs: List[Mp3Decoder], nch: int, ngr: int,
                          device: torch.device, to_device: bool = False):
        lib = _native.get_lib()
        if lib is None:
            raise RuntimeError("the MP3 batch path needs the C host stage "
                               "(host/src/af_host.cc), which did not load")
        pending = self._decode_mp3_group_packed(decs, nch, ngr, lib, device,
                                                to_device)
        group = _PendingGroup("mp3", decs, pending, self._mp3_finalize,
                              (decs, pending, nch))
        return group if to_device else group.finalize()

    def _decode_mp3_group_packed(self, decs, nch: int, ngr: int, lib,
                                 device: torch.device,
                                 to_device: bool = False):
        """Device-Huffman lockstep over the pooled wire: per window the C
        stage parses W frames of every lane (mp3_window_frames: 24 on the
        CPU, sized to the batch on the card) into each frame's main data
        words, side info and quarter-exponent scalefactors of its
        granule-channels (one C call per lane chunk, on a parse pool); the
        frames' words pack into one exact-size u32 pool (frame after frame,
        each granule-channel addressing its frame's words by bit position);
        one dispatch worker uploads it and
        runs ops/mp3_huff.packed_window — the Huffman kernel (K3), the
        window kernel (K14: dequant, stereo mix, reorder, antialias, IMDCT
        and overlap-add) and the synthesis product — with the carried
        overlap and slot history.  Returns the pending (PCM window, n_act)
        list."""
        B = len(decs)
        LPF = ngr * nch  # lanes a frame
        # the longest lane's frames: its frame index past its position
        frames_left = max(len(d._index_offsets) - int(np.searchsorted(
            d._index_offsets, d._offset)) for d in decs)
        W = mp3_window_frames(B * LPF, frames_left, mp3_wave_lanes(device))
        with self._stats_lock:
            self.stats["mp3_window_frames"] = max(
                W, self.stats["mp3_window_frames"])
        G = W * ngr
        NL = G * nch
        FW = _native.FRAME_WORDS
        dev_state = {
            "overlap": torch.zeros((B, nch, 32, 18), dtype=torch.float32,
                                   device=device),
            "shist": torch.zeros((B, nch, 16, 32), dtype=torch.float32,
                                 device=device),
        }
        active = np.ones(B, bool)
        # per-lane state as batch-contiguous rows: the multi-lane C entry
        # (af_mp3_parse_window_packed_multi) derives lane pointers from
        # base + lane * stride
        data_keep = []
        data_ptrs = np.zeros(B, np.uint64)
        data_lens = np.zeros(B, np.int64)
        offs_a = np.zeros(B, np.int64)
        hdr0s = np.zeros((B, 4), np.uint8)
        ffb = np.zeros(B, np.int32)
        rb_all = np.zeros((B, 511), np.uint8)
        rl_all = np.zeros(B, np.int32)
        ist_all = np.zeros((B, 2, 40), np.int32)
        for bi, d in enumerate(decs):
            addr, nb, keep = _native.buf_addr(d._view)
            data_keep.append(keep)
            data_ptrs[bi] = addr
            data_lens[bi] = nb
            offs_a[bi] = d._offset
            hdr0s[bi] = np.frombuffer(d._hdr0, np.uint8, 4)
            ffb[bi] = d._free_format_bytes
            cur = d._reserv_buf
            if cur:
                rb_all[bi, : len(cur)] = np.frombuffer(cur, np.uint8)
                rl_all[bi] = min(d._reserv, len(cur))
            ist_all[bi] = d._ist_pos
        flags_all = np.zeros((B, W), np.uint8)
        aa_all = np.zeros((B, G, nch), np.int32)
        wt_all = np.zeros((B, G, nch, 32), np.int32)
        n_out = np.zeros(B, np.int32)
        mw_all = np.zeros(B, np.int32)
        idx_w = np.arange(W)
        win = {}  # this window's host arrays, rebound every window

        def _parse_chunk(lanes):
            t = trace.timer("parse_chunk", cpu=True, ctx=win["ctx"],
                            format="mp3", lanes=len(lanes))
            try:
                gated = []
                for bi in lanes:
                    d = decs[bi]
                    if offs_a[bi] >= data_lens[bi] - 4 or (
                        d._total_samples
                        and d._cur_sample >= d._total_samples
                    ):
                        active[bi] = False
                    else:
                        gated.append(bi)
                if gated:
                    _native.mp3_parse_window_packed_multi(
                        lib, gated, data_ptrs, data_lens, offs_a, hdr0s,
                        W, ffb, rb_all, rl_all, ist_all, win["bits"],
                        mw_all, win["meta"], win["scfq"],
                        win["ists"] if nch == 2 else None,
                        aa_all, wt_all, flags_all, n_out)
                return gated
            finally:
                self._note_host_cpu("mp3", t)

        def _post_parse(gated):
            """Frame activity, intensity flags, the rare compaction of
            silent-frame holes to the n_act prefix the window DSP needs,
            and the per-decoder positions.  Returns the window's widest
            lane in words."""
            if not gated:
                return 16
            bits, meta, scfq, ists = (win[k] for k in
                                      ("bits", "meta", "scfq", "ists"))
            g = np.asarray(gated, np.int64)
            ng = n_out[g]
            fl = flags_all[g]
            validm = idx_w[None, :] < ng[:, None]
            actm = ((fl & 1) != 0) & validm
            n_fr_g = actm.sum(1)
            win["win_ist"][g] = (((fl & 4) != 0) & validm).any(1)
            win["n_act"][g] = (n_fr_g * ngr).astype(np.int32)
            pref = actm.cumsum(1)
            hole = np.zeros(g.size, bool)
            nz = n_fr_g > 0
            hole[nz] = pref[nz, n_fr_g[nz] - 1] < n_fr_g[nz]
            for i in np.flatnonzero(hole):
                bi = int(g[i])
                fi = np.flatnonzero(actm[i])
                bits[bi, : len(fi)] = bits[bi, fi]
                li = np.flatnonzero(np.repeat(actm[i], LPF))
                meta[bi, : len(li)] = meta[bi, li]
                scfq[bi, : len(li)] = scfq[bi, li]
                meta[bi, len(li):] = 0
                gi = np.flatnonzero(np.repeat(actm[i], ngr))
                ists[bi, : len(gi)] = ists[bi, gi]
                ists[bi, len(gi):] = 0
            for i, bi in enumerate(gated):
                d = decs[bi]
                d._offset = int(offs_a[bi])
                d._cur_sample += int(n_fr_g[i]) * ngr * 576 * nch
                if ng[i] < W:
                    active[bi] = False
            return max(16, int(mw_all[g].max()))

        def _dispatch(pool_w, meta16, scfq, ists, n_act, Wrow, short, h2d,
                      ctx, k):
            with trace.span("upload", ctx=ctx, format="mp3", window=k,
                            bytes=h2d):
                pool_d, meta_d, scf_d, n_act_d = _upload(
                    device, pool_w, meta16, scfq, n_act)
                ist_d = None if ists is None else _upload(device, ists)[0]
            with trace.span("launch", ctx=ctx, format="mp3",
                            window=k, lanes=B * NL) as sp:
                n0 = mp3_huff.HUFF_LAUNCHES
                d0 = mp3_dsp.DSP_LAUNCHES
                pcm, dev_state["overlap"], dev_state["shist"] = \
                    mp3_huff.packed_window(
                        pool_d, meta_d, scf_d, ist_d, dev_state["overlap"],
                        dev_state["shist"], n_act_d, B=B, G=G, nch=nch,
                        W=Wrow, mpeg1=ngr == 2, short=short)
                out = _prefetch(pcm, to_device)
                sp.set(launches=mp3_huff.HUFF_LAUNCHES - n0,
                       dsp_launches=mp3_dsp.DSP_LAUNCHES - d0)
            return out

        pending = []
        # one dispatch worker: window t+1's parse overlaps window t's
        # upload and device chain
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="af-dispatch")
        n_workers = max(1, min(8, (os.cpu_count() or 1)))
        parse_pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="af-parse") \
            if n_workers > 1 else None
        short_pats = np.zeros(mp3_huff.N_PATTERNS, bool)
        short_pats[list(mp3_huff.SHORT_PATTERNS)] = True
        try:
            for k in itertools.count():
                if not active.any():
                    break
                with trace.span("window", format="mp3", window=k,
                                lanes=int(active.sum()), frames=W):
                    win["ctx"] = trace.context()
                    t_host = trace.timer("parse")
                    win.update(
                        bits=np.empty((B, W, FW), np.uint32),
                        meta=np.zeros((B, NL, 16), np.int32),
                        scfq=np.zeros((B, NL, 40), np.int16),
                        ists=np.zeros((B, G, 40), np.int16),
                        win_ist=np.zeros(B, bool),
                        n_act=np.zeros(B, np.int32))
                    live = [bi for bi in range(B) if active[bi]]
                    if parse_pool is not None:
                        gated = [bi for sub in parse_pool.map(
                            _parse_chunk, _lane_chunks(live, n_workers))
                            for bi in sub]
                    else:
                        gated = _parse_chunk(live)
                    mw_max = _post_parse(gated)
                    self._note_stage("host_ms", "mp3", t_host)
                    n_act = win["n_act"]
                    if not n_act.any():
                        break
                    t_enq = trace.timer("enqueue")
                    meta = win["meta"]
                    L = B * NL
                    with trace.span("pack", format="mp3", window=k):
                        meta16 = mp3_huff.meta16_from_c(meta).reshape(L, 16)
                        # one C pass copies each frame's span of words into
                        # the pool
                        span32 = np.ascontiguousarray(
                            meta16[::LPF, mp3_huff.M_SPAN], np.int32)
                        pool_w = np.empty(int(span32.sum()), np.uint32)
                        u32p = ctypes.POINTER(ctypes.c_uint32)
                        lib.af_u32_pack_prefix_rows(
                            win["bits"].reshape(B * W, FW).ctypes.data_as(
                                u32p),
                            B * W, FW,
                            span32.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int32)),
                            pool_w.ctypes.data_as(u32p))
                    ists = win["ists"].reshape(B * G, 40) \
                        if nch == 2 and win["win_ist"].any() else None
                    short = bool(short_pats[meta[:, :, 10]].any())
                    scfq = win["scfq"].reshape(L, 40)
                    h2d = (pool_w.nbytes + meta16.nbytes + scfq.nbytes
                           + n_act.nbytes
                           + (0 if ists is None else ists.nbytes))
                    fut = pool.submit(_dispatch, pool_w, meta16, scfq, ists,
                                      n_act, mp3_huff.row_width(mw_max),
                                      short, h2d, win["ctx"], k)
                    self._note_stage("enqueue_ms", "mp3", t_enq)
                    self._stat_add("h2d_bytes", h2d)
                    self._stat_add("h2d_bytes_by_format", h2d, fmt="mp3")
                    self._note_window("mp3")
                    pending.append((fut, n_act))
        finally:
            # a lane fault raising out of the window loop must not leak the
            # dispatch or parse workers; the main thread waits here for the
            # dispatch worker's last windows
            with trace.span("wait", format="mp3"):
                pool.shutdown(wait=True)
            if parse_pool is not None:
                parse_pool.shutdown(wait=True)
        # the parse ran against the batch copy of the persistent intensity
        # positions; write them back so the decoders stay consistent
        for bi, d in enumerate(decs):
            d._ist_pos[:] = ist_all[bi]
        return [(f.result(), n) for f, n in pending]

    def _mp3_finalize(self, decs, pending, nch):
        """Download the pending windows and assemble each lane's PCM (delay
        skip, total-length clamp)."""
        outputs = [[] for _ in decs]
        t0 = time.perf_counter()
        for pcm_dev, n_act in pending:
            pcm = _to_numpy(pcm_dev)
            self._stat_add("d2h_bytes", pcm.nbytes)
            for bi in range(len(decs)):
                n = int(n_act[bi])
                if n:
                    outputs[bi].append(
                        pcm[bi, :n].transpose(0, 2, 1).reshape(-1, nch))
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        result = []
        for bi, d in enumerate(decs):
            pcm = np.concatenate(outputs[bi]) if outputs[bi] else \
                np.zeros((0, nch), np.float32)
            pcm = pcm[d._start_delay // nch:]
            if d._total_samples:
                pcm = pcm[: d._total_samples // nch]
            result.append(pcm)
        return result

    # ------------------------------------------------ batched FLAC lockstep
    def _decode_flac_group(self, decs: List[FlacDecoder], nch: int,
                           device: torch.device, to_device: bool = False):
        """FLAC lockstep over the packed wire: the C host stage Rice-decodes
        W frames per lane, packs the residual rows at the window's bit
        width, and one upload plus one device chain (unpack → overflow
        merge → LPC kernel → stereo decorrelation) runs per window."""
        B = len(decs)
        W = FLAC_WINDOW_FRAMES
        outputs = [[] for _ in range(B)]
        active = np.ones(B, dtype=bool)
        pending = []  # (device out32, [(slot, si, blocksize), ...])

        # one dispatch worker: window t+1's host parse overlaps window t's
        # pack, upload and device chain
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="af-dispatch")
        n_workers = max(1, min(8, (os.cpu_count() or 1)))
        parse_pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="af-parse") \
            if n_workers > 1 else None
        wctx = [None]   # the window span, for the parse workers' spans

        parse_lib = _native.get_lib()

        def _host_frame(d, bi, bs, ca, residual, coeffs, order, shift,
                        wasted):
            # beyond the 18-bit range of the device lanes: exact int64 on
            # the host
            outputs[bi].append(_flac_host_frame(
                residual, coeffs, order, shift, ca, wasted,
                d.bits_per_sample))

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
            t = trace.timer("parse_chunk", cpu=True, ctx=wctx[0],
                            format="flac", lanes=len(lanes))
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
                self._note_host_cpu("flac", t)

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
            t = trace.timer("parse_chunk", cpu=True, ctx=wctx[0],
                            format="flac", lanes=len(lanes))
            try:
                return [_parse_lane_inner(bi) for bi in lanes]
            finally:
                self._note_host_cpu("flac", t)

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
                           use_s16, ctx, k):
            # everything per-window arrives as an argument: the enclosing
            # loop rebinds its locals while this runs.  `rows`/`ns` address
            # the parser's residual rows in place; `keep` holds per-lane
            # parse buffers alive until the pack reads them (fmulti rows
            # live in the double-buffered res_buf, gated by buf_futs).
            Ln = S * nch
            h2d = 0
            n0 = lpc_ops.KERNEL_LAUNCHES
            if parse_lib is not None:
                _i32p = ctypes.POINTER(ctypes.c_int32)
                _u32p = ctypes.POINTER(ctypes.c_uint32)
                _i64p = ctypes.POINTER(ctypes.c_int64)
                with trace.span("pack", ctx=ctx, format="flac", window=k):
                    w_l = np.zeros(Ln, np.int32)
                    wmax = parse_lib.af_flac_widths_gather(
                        rows.ctypes.data_as(_i64p), Ln, max_bs,
                        ns.ctypes.data_as(_i32p),
                        order.ctypes.data_as(_i32p),
                        w_l.ctypes.data_as(_i32p))
                    # residual widths are heavy-tailed (verbatim blocks,
                    # high-order partitions): pad every row to the max
                    # bucket, or pack small and ship the few wide rows apart
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
                        wb2 = next((x for x in _FLAC_W_BUCKETS
                                    if wmax <= x), 32)
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
                nb = packed.nbytes + warm.nbytes
                with trace.span("upload", ctx=ctx, format="flac", window=k,
                                bytes=nb):
                    (packed_d, warm_d, coeffs, order_d, shift, exact,
                     assigns, wasteds, out_shifts) = _upload(
                        device, packed, warm, coeffs, order, shift, exact,
                        assigns, wasteds, out_shifts)
                h2d += nb
                with trace.span("launch", ctx=ctx, format="flac", window=k):
                    residual_d = lpc_ops.flac_unpack_residuals(
                        packed_d, warm_d, order_d, w=wb, n=max_bs)
                if Lb:
                    nb = (packed2.nbytes + warm2.nbytes + order2.nbytes
                          + ovf_idx.nbytes)
                    with trace.span("upload", ctx=ctx, format="flac",
                                    window=k, bytes=nb):
                        p2_d, w2_d, o2_d, idx_d = _upload(
                            device, packed2, warm2, order2, ovf_idx)
                    h2d += nb
                    with trace.span("launch", ctx=ctx, format="flac",
                                    window=k):
                        res_o = lpc_ops.flac_unpack_residuals(
                            p2_d, w2_d, o2_d, w=wb2, n=max_bs)
                        residual_d = lpc_ops.flac_merge_overflow(
                            residual_d, res_o, idx_d)
            else:
                with trace.span("upload", ctx=ctx, format="flac", window=k,
                                bytes=residual.nbytes):
                    (residual_d, coeffs, order_d, shift, exact, assigns,
                     wasteds, out_shifts) = _upload(
                        device, residual, coeffs, order, shift, exact,
                        assigns, wasteds, out_shifts)
                h2d += residual.nbytes
            with trace.span("launch", ctx=ctx, format="flac",
                            window=k) as sp:
                samples = lpc_ops.flac_lpc(
                    residual_d, coeffs, order_d, shift, exact
                ).reshape(S, nch, max_bs)
                # <=16-bit lanes (out_shift >= 16): ship int16 losslessly
                # to halve the device->host bytes
                post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                    else lpc_ops.flac_post_stereo_batch
                out32 = post(samples, assigns, wasteds, out_shifts)
                out = _prefetch(out32, to_device)
                sp.set(launches=lpc_ops.KERNEL_LAUNCHES - n0)
            return out, h2d

        try:
            buf_futs = [None, None]   # dispatch future per buffer parity
            wpar = 0
            for k in itertools.count():
                if not active.any():
                    break
                with trace.span("window", format="flac", window=k,
                                lanes=int(active.sum())):
                    if fmulti:
                        # rows of the window that used this buffer (two
                        # windows ago) must be packed before reuse
                        if buf_futs[wpar] is not None:
                            with trace.span("wait", format="flac", window=k):
                                buf_futs[wpar].result()
                        res_buf = res_buf_alt if wpar else res_buf_first
                    # host entropy stage: parse up to W frames per stream
                    wctx[0] = trace.context()
                    t_host = trace.timer("parse")
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
                    t_enq = trace.timer("enqueue")
                    # bucket the lane count (multiples of 128 past 128) and the
                    # block length, so window shapes repeat
                    n_l = len(lanes)
                    S = max(8, 1 << (n_l - 1).bit_length()) if n_l <= 128 \
                        else -(-n_l // 128) * 128
                    max_bs = -(-max_bs // 1024) * 1024
                    coeffs = np.zeros((S * nch, 32), np.int32)
                    # pad rows: pass-through
                    order = np.full(S * nch, max_bs, np.int32)
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
                        max_bs, S, use_s16, wctx[0], k)
                    self._note_stage("enqueue_ms", "flac", t_enq)
                    self._note_window("flac")
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
            # no worker outlives a lane fault mid-window; the main thread
            # waits here for the dispatch worker's last windows
            with trace.span("wait", format="flac"):
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
        return _flac_pcm(decs, outputs, nch)

    # -------------------------------------- batched FLAC, device-Rice wire
    def _decode_flac_group_rice(self, decs: List[FlacDecoder], nch: int,
                                device: torch.device,
                                to_device: bool = False):
        """FLAC lockstep over the device-Rice wire: the host runs only the
        byte-level frame sync index, one C call a window for every live
        lane; the raw frame bytes cross to the device once, and the
        frame-entropy kernel decodes subframe headers and residuals, which
        the LPC kernel and the stereo stage turn into PCM.  A group of
        RICE_GATHER_MIN_BYTES or more uploads its streams as one corpus and
        gathers each dispatch's frame pool on the device; a smaller one
        builds the pool on the host a dispatch.  The corpus is this call's
        own: concurrent groups never share one.  Frames the device flags
        (corrupt, wider than 18 bits, or an end that does not meet the next
        frame's start) are decoded again on the host."""
        lib = _native.get_lib()
        B = len(decs)
        outputs = [[] for _ in range(B)]
        pending = []
        for d in decs:
            if not hasattr(d, "_rice_state"):
                d._rice_state = np.array([-1, 0, d._cur_bit // 8], np.int64)
        blk_b = flac_rice.BLK_W * 4
        total = sum(len(d._view) for d in decs)
        corpus = None
        if total >= RICE_GATHER_MIN_BYTES and total + 3 * blk_b < (1 << 31):
            # every stream's bytes end to end, then the zero tail the
            # gather reads for blocks past the last frame
            zero_off = total + (-total) % 4
            buf = np.zeros(zero_off + 2 * blk_b, np.uint8)
            stream_base = np.zeros(B, np.int64)
            cur = 0
            for bi, d in enumerate(decs):
                nb = len(d._view)
                buf[cur: cur + nb] = np.frombuffer(d._view, np.uint8, nb, 0)
                stream_base[bi] = cur
                cur += nb
            (corpus_d,) = _upload(device, buf.view(np.int32))
            corpus = (corpus_d, stream_base, zero_off)
            self._stat_add("h2d_bytes", buf.nbytes)
            self._stat_add("h2d_bytes_by_format", buf.nbytes, fmt="flac")
        # one dispatch worker: window k+1's sync index and pool overlap
        # window k's device chain
        pool_w = ThreadPoolExecutor(max_workers=1)
        try:
            self._flac_rice_windows(decs, nch, device, to_device, lib,
                                    corpus, outputs, pending, pool_w)
        finally:
            # no worker outlives a lane fault mid-window
            pool_w.shutdown(wait=True)
        # the frame checks, after every window was enqueued: the flags'
        # downloads wait for their window's device chain
        resolved = []
        for fut, slots, base_bits, sizes in pending:
            out, err_d, endb_d, subbps_d = fut.result()
            err = err_d.cpu().numpy()
            endb = endb_d.cpu().numpy().astype(np.int64) - base_bits
            wide = subbps_d.cpu().numpy().max(axis=1) > 18
            # the frame's end, byte-aligned, plus its CRC-16 must meet the
            # next frame's start (sizes 0: a stream's last frame, unchecked)
            chain = ((((endb + 7) // 8) * 8 + 16 != sizes * 8)
                     & (sizes > 0))
            resolved.append((out, err | wide | chain, slots))
        pending[:] = resolved
        group = _PendingGroup("flac", decs, pending,
                              self._flac_finalize_rice,
                              (decs, outputs, pending, nch))
        return group if to_device else group.finalize()

    def _flac_rice_windows(self, decs, nch, device, to_device, lib, corpus,
                           outputs, pending, pool_w):
        """The device-Rice window loop: one af_flac_sync_index_multi call a
        window indexes up to W frames of every live lane (each lane's sync
        state is a row of a batch array, written back to its decoder at the
        end); the window's frames go to _flac_rice_enqueue."""
        B = len(decs)
        W = FLAC_WINDOW_FRAMES
        active = np.ones(B, dtype=bool)
        keep = []
        ptrs = np.zeros(B, np.uint64)
        lens = np.zeros(B, np.int64)
        bps_in = np.zeros(B, np.int32)
        st_all = np.zeros((B, 3), np.int64)
        for bi, d in enumerate(decs):
            addr, nb, k = _native.buf_addr(d._view)
            keep.append(k)
            ptrs[bi] = addr
            lens[bi] = nb
            bps_in[bi] = d.bits_per_sample
            st_all[bi] = d._rice_state
        offs_w = np.zeros((B, W), np.int64)
        dbits_w = np.zeros((B, W), np.int64)
        bs_w = np.zeros((B, W), np.int32)
        ca_w = np.zeros((B, W), np.int32)
        bpsf_w = np.zeros((B, W), np.int32)
        n_w = np.zeros(B, np.int32)
        while active.any():
            t_host = trace.timer("parse", cpu=True)
            live = []
            for bi in np.flatnonzero(active).tolist():
                d = decs[bi]
                if d._frame_pos >= d.length_frames > 0:
                    active[bi] = False
                else:
                    live.append(bi)
            if live:
                _native.flac_sync_index_multi(
                    lib, live, ptrs, lens, bps_in, nch, 65535, W, st_all,
                    offs_w, dbits_w, bs_w, ca_w, bpsf_w, n_w)
            # (bi, byte_off, size, rel_bit, bs, ca, bps, chk)
            lanes = []
            for bi in live:
                n = int(n_w[bi])
                if n == 0:
                    active[bi] = False
                    continue
                o = offs_w[bi, :n]
                end = int(st_all[bi, 2])
                if n == W and end + 16 <= lens[bi]:
                    # the state's resume byte is the synced next frame
                    nxt, chk_last = end, True
                else:
                    # a stream's end: no next frame, ship through EOF and
                    # skip the chain check
                    nxt, chk_last = int(lens[bi]), False
                sizes = (np.append(o[1:], nxt) - o).tolist()
                rel = (dbits_w[bi, :n] - o * 8).tolist()
                bsl = bs_w[bi, :n].tolist()
                lanes.extend(
                    (bi, oi, sizes[i], rel[i], bsl[i], int(ca_w[bi, i]),
                     int(bpsf_w[bi, i]), chk_last if i == n - 1 else True)
                    for i, oi in enumerate(o.tolist()))
                decs[bi]._frame_pos += sum(bsl)
                if n < W:
                    active[bi] = False
            self._note_stage("host_ms", "flac", t_host)
            self._note_host_cpu("flac", t_host)
            if not lanes:
                break
            self._flac_rice_enqueue(decs, lanes, nch, outputs, pending,
                                    pool_w, device, to_device, ptrs, corpus)
        # chunked reads continue across groups from the sync state
        for bi, d in enumerate(decs):
            d._rice_state[:] = st_all[bi]

    def _flac_rice_enqueue(self, decs, lanes, nch, outputs, pending, pool_w,
                           device, to_device, lane_addrs, corpus):
        """Split a window's frames into dispatches whose pools, with the two
        guard blocks, stay within RICE_DISPATCH_BLOCKS."""
        blk_b = flac_rice.BLK_W * 4
        chunks, cur, blocks = [], [], 0
        for p in lanes:
            nb = -(-p[2] // blk_b)
            if cur and blocks + nb + 2 > RICE_DISPATCH_BLOCKS:
                chunks.append(cur)
                cur, blocks = [], 0
            cur.append(p)
            blocks += nb
        chunks.append(cur)
        for sub in chunks:
            self._rice_dispatch_lanes(decs, sub, nch, outputs, pending,
                                      pool_w, device, to_device, lane_addrs,
                                      corpus)

    def _rice_dispatch_lanes(self, decs, lanes, nch, outputs, pending,
                             pool_w, device, to_device, lane_addrs, corpus):
        """Build and submit one device-Rice dispatch: the frame pool (or
        its gather indices), the per-frame arrays, and the worker's device
        chain (pool → frame-entropy kernel → LPC kernel → stereo)."""
        t_enq = trace.timer("enqueue")
        S = len(lanes)
        max_bs = max(p[4] for p in lanes)
        max_bs = next((x for x in (256, 1024, 4096) if max_bs <= x),
                      -(-max_bs // 4096) * 4096)
        NPOOL = flac_rice.pool_blocks_needed([p[2] for p in lanes])
        t_pb = time.perf_counter()
        if corpus is not None:
            corpus_d, stream_base, zero_off = corpus
            lane_src, cum_dst, base_bits = flac_rice.gather_pool_meta(
                stream_base, lanes, S, zero_off)
            pool = None
        else:
            pool, base_bits = flac_rice.build_frame_pool_native(
                _native.get_lib(), lane_addrs, lanes, NPOOL)
            lane_src = cum_dst = None
        self._stat_add("enq_flac_poolbuild_ms",
                       (time.perf_counter() - t_pb) * 1e3)
        bi_c, _off_c, size_c, rel_c, bs_c, ca_c, bps_c, chk_c = zip(*lanes)
        start_bits = (base_bits + np.asarray(rel_c, np.int64))\
            .astype(np.int32)
        bs_arr = np.asarray(bs_c, np.int32)
        ca_arr = np.asarray(ca_c, np.int32)
        bps_arr = np.asarray(bps_c, np.int32)
        sizes = np.where(np.asarray(chk_c, bool),
                         np.asarray(size_c, np.int64), 0)
        lane_bps = np.fromiter((decs[bi].bits_per_sample for bi in bi_c),
                               np.int32, S)
        use_s16 = bool((lane_bps <= 16).all())
        out_shifts = (32 - lane_bps).astype(np.int32)

        def _dispatch(pool, lane_src, cum_dst, start_bits, bs_arr, ca_arr,
                      bps_arr, out_shifts, NPOOL, max_bs, use_s16):
            # every per-dispatch value arrives as an argument: the caller
            # rebinds its locals while this runs
            if pool is None:
                ls_d, cum_d = _upload(device, lane_src, cum_dst)
                blocks_d = flac_rice.gather_frame_pool(
                    corpus_d, ls_d, cum_d, zero_off, NPOOL, S)
            else:
                (pool_d,) = _upload(device, pool)
                blocks_d = flac_rice.pad_pool(pool_d, NPOOL)
            sb_d, bs_d, bps_d, ca_d, osh_d = _upload(
                device, start_bits, bs_arr, bps_arr, ca_arr, out_shifts)
            ent = flac_rice.flac_frame_entropy(
                blocks_d, sb_d, bs_d, bps_d, ca_d, L=S, NSAMP=max_bs,
                nch=nch, NPOOL=NPOOL)
            Ln = S * nch
            sub_bps = ent["sub_bps"]
            samples = lpc_ops.flac_lpc(
                ent["residual"].reshape(Ln, max_bs),
                ent["coeffs"].reshape(Ln, 32), ent["order"].reshape(Ln),
                ent["shift"].reshape(Ln), (sub_bps > 16).reshape(Ln),
            ).reshape(S, nch, max_bs)
            post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                else lpc_ops.flac_post_stereo_batch
            out = post(samples, ca_d, ent["wasted"], osh_d)
            return (_prefetch(out, to_device), ent["err"], ent["end_bits"],
                    sub_bps)

        fut = pool_w.submit(_dispatch, pool, lane_src, cum_dst, start_bits,
                            bs_arr, ca_arr, bps_arr, out_shifts, NPOOL,
                            max_bs, use_s16)
        if pool is not None:
            self._stat_add("h2d_bytes", pool.nbytes)
            self._stat_add("h2d_bytes_by_format", pool.nbytes, fmt="flac")
        self._note_stage("enqueue_ms", "flac", t_enq)
        self._note_window("flac")
        slots = []
        for si, (bi, off, _size, _rel, bs, _ca, _bps, _chk) in \
                enumerate(lanes):
            slot = [None]
            outputs[bi].append(slot)
            slots.append((slot, si, bs, bi, off))
        pending.append((fut, slots, base_bits, sizes))

    def _flac_finalize_rice(self, decs, outputs, pending, nch):
        lib = _native.get_lib()
        t0 = time.perf_counter()
        n_redo = 0
        corrupt = set()      # lanes with a flagged frame the host cannot parse
        for out, bad, slots in pending:
            arr = _to_numpy(out)
            self._stat_add("d2h_bytes", arr.nbytes)
            for slot, si, bs, bi, off in slots:
                if bad[si]:
                    d = decs[bi]
                    nat = _native.flac_parse_frame(
                        lib, d._view, off * 8, d.bits_per_sample, nch, 65535)
                    if nat is None:
                        # the stream ends at an unparseable frame, as in the
                        # single-stream decoder: no error, fewer samples
                        corrupt.add(bi)
                        slot[0] = np.zeros((0, nch), np.int32)
                        continue
                    slot[0] = _flac_host_frame(
                        nat["residual"], nat["coeffs"], nat["order"],
                        nat["shift"], nat["chan_assignment"], nat["wasted"],
                        d.bits_per_sample)[:bs]
                    n_redo += 1
                elif arr.dtype == np.int16:
                    slot[0] = arr[si, :, :bs].T.astype(np.int32) << 16
                else:
                    slot[0] = arr[si, :, :bs].T
        if n_redo:
            self._stat_add("rice_host_redo", n_redo)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        for bi in corrupt:
            self._stat_add("flac_truncated_lanes", 1)
            # drop the lane's frames from the unparseable one on (slots are
            # in frame order)
            seen = False
            for c in outputs[bi]:
                seen = seen or c[0].shape[0] == 0
                if seen:
                    c[0] = np.zeros((0, nch), np.int32)
        return _flac_pcm(decs, outputs, nch)

    # --------------------------------------------------- batched QOA frames
    def _decode_qoa_group(self, decs: List[QoaDecoder], nch: int,
                          device: torch.device, to_device: bool = False):
        """QOA batching: LMS state is in-band per frame (qoa.d:488-503), so
        every frame of every stream is an independent lane — the whole
        group decodes as a few large [lanes, 5120] device calls.  Slice
        payloads ship as int8 (3-bit codes, 4-bit scalefactors) and the
        kernel dequantizes them as it decodes."""
        FULL_S = lms_ops.QOA_SLICES_PER_FRAME
        t_host = trace.timer("parse", cpu=True)
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
            self._note_host_cpu("qoa", t_host)
            L = hist.shape[0]
            for c0 in range(0, L, QOA_WINDOW_LANES):
                t_enq = trace.timer("enqueue")
                sl = slice(c0, min(L, c0 + QOA_WINDOW_LANES))
                arrays = (hist[sl], wts[sl], sf8[sl], cd8[sl])
                out = lms_ops.decode_slices(*_upload(device, *arrays))
                pending.append((_prefetch(out, to_device), sl.stop - c0))
                self._note_stage("enqueue_ms", "qoa", t_enq)
                h2d = sum(a.nbytes for a in arrays)
                self._stat_add("h2d_bytes", h2d)
                self._stat_add("h2d_bytes_by_format", h2d, fmt="qoa")
                self._note_window("qoa")
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

    # --------------------------------------------------- batched WAV lanes
    def _decode_wav_group(self, decs: List[WavDecoder], kind: str,
                          device: torch.device, to_device: bool = False):
        """WAV batching: int → f32 is elementwise, so every lane of one
        sample kind rides one device call.  Each lane's raw payload bytes
        (frame-aligned, so lane boundaries stay sample boundaries) join one
        buffer that goes up as it is, and K10 unpacks and converts it on
        the device: 2 bytes a sample up for s16."""
        t_host = trace.timer("parse", cpu=True)
        parts = []
        counts = []  # (frames, channels) a lane
        for d in decs:
            frames = d.length_frames - d._frame_pos
            parts.append(np.frombuffer(d._raw_frames(frames), np.uint8))
            counts.append((frames, d.channels))
            d._frame_pos += frames
        raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        self._note_stage("host_ms", "wav", t_host)
        self._note_host_cpu("wav", t_host)
        t_enq = trace.timer("enqueue")
        out = pcm_ops.decode_bytes(torch.from_numpy(raw).to(device), kind)
        pending = [(_prefetch(out, to_device),)]
        self._note_stage("enqueue_ms", "wav", t_enq)
        self._stat_add("h2d_bytes", raw.nbytes)
        self._stat_add("h2d_bytes_by_format", raw.nbytes, fmt="wav")
        self._note_window("wav")
        group = _PendingGroup("wav", decs, pending, self._wav_finalize,
                              (counts, pending))
        return group if to_device else group.finalize()

    def _wav_finalize(self, counts, pending):
        t0 = time.perf_counter()
        flat = _to_numpy(pending[0][0])
        self._stat_add("d2h_bytes", flat.nbytes)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        result = []
        off = 0
        for frames, ch in counts:
            n = frames * ch
            result.append(flat[off: off + n].reshape(frames, ch))
            off += n
        return result

    # ------------------------------------------------ batched Vorbis lanes
    def _decode_vorbis_group(self, decs: List[VorbisDecoder], nch: int,
                             device: torch.device, to_device: bool = False):
        """Vorbis lockstep: the host runs the entropy stage (codebooks,
        floors, residues, coupling, floor dot) of K packets a lane; one
        upload of the window's spectra X [K, L, bs1/2] and geometry, and one
        device chain (ops/vorbis_win.vorbis_window_chain: both block sizes'
        IMDCT matmuls, then K11's lapped chain with the lap carried on the
        device) a window.  Each packet's output length follows from the
        geometry on the host, so nothing downloads until finalize(), for
        either output."""
        B = len(decs)
        bs0, bs1 = decs[0]._bs0, decs[0]._bs1
        h = bs1 // 2
        L = B * nch
        K = VORBIS_WINDOW_PACKETS
        dev = device
        state = (torch.zeros((L, h), dtype=torch.float32, device=dev),
                 torch.zeros(B, dtype=torch.int32, device=dev),
                 torch.zeros(B, dtype=torch.int32, device=dev))
        host_hp = np.zeros(B, bool)  # host mirror of had_prev
        active = np.ones(B, bool)
        pending = []
        while active.any():
            t_host = trace.timer("parse", cpu=True)
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
            self._note_stage("host_ms", "vorbis", t_host)
            self._note_host_cpu("vorbis", t_host)
            if not geom[3].any():
                break
            t_enq = trace.timer("enqueue")
            X_d, g_d = _upload(dev, X, geom)
            pcm, *st = vorbis_win.vorbis_window_chain(
                X_d, g_d[0], g_d[1], g_d[2], g_d[3], *state,
                bs0=bs0, bs1=bs1, ch=nch)
            state = tuple(st)
            pending.append((_prefetch(pcm, to_device), lens))
            self._note_stage("enqueue_ms", "vorbis", t_enq)
            self._stat_add("h2d_bytes", X.nbytes + geom.nbytes)
            self._stat_add("h2d_bytes_by_format", X.nbytes + geom.nbytes,
                           fmt="vorbis")
            self._note_window("vorbis")
        group = _PendingGroup("vorbis", decs, pending, self._vorbis_finalize,
                              (decs, pending, nch))
        return group if to_device else group.finalize()

    def _vorbis_finalize(self, decs, pending, nch):
        t0 = time.perf_counter()
        outs = [[] for _ in decs]
        for pcm, lens in pending:
            arr = _to_numpy(pcm)  # [K, L, bs1]
            self._stat_add("d2h_bytes", arr.nbytes)
            for bi in range(len(decs)):
                for k in range(arr.shape[0]):
                    n = int(lens[k, bi])
                    if n:
                        outs[bi].append(
                            arr[k, bi * nch: (bi + 1) * nch, :n].T)
        res = [
            np.ascontiguousarray(np.concatenate(o), dtype=np.float32)
            if o else np.zeros((0, nch), np.float32)
            for o in outs
        ]
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        return res

    # ------------------------------------------------ batched Opus lockstep
    @staticmethod
    def _opus_eligible(d) -> bool:
        """Lockstep-eligible: a mapping-0 stream whose packets are all
        CELT-only with one frame size (music streams, the common case).
        Stashes the packets on the decoder."""
        if d.channel_mapping != 0 or d.s16_parity:
            return False
        try:
            pkts = d._collect_packets()
        except AudioFormatError:
            return False
        if not pkts:
            return False
        fs = None
        for data in pkts:
            pk = _opus_parse(data)
            if pk is None or pk["mode"] != "celt":
                return False
            if fs is None:
                fs = pk["frame_size"]
            elif pk["frame_size"] != fs:
                return False
        d._lockstep_packets = pkts
        return True

    def _celt_imdct_bucket(self, items, blocks, bs, device):
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
        t0 = time.perf_counter()
        (flat,) = _upload(device, np.concatenate([co.ravel(),
                                                   tails.ravel()]))
        self._stat_add("enq_opus_upload_ms", (time.perf_counter() - t0) * 1e3)
        nb = co.nbytes + tails.nbytes
        self._stat_add("h2d_bytes", nb)
        self._stat_add("h2d_bytes_by_format", nb, fmt="opus")
        buf = celt_dsp.celt_imdct_ola_packed(
            flat[: rows * frame].view(rows, frame),
            flat[rows * frame:].view(rows, half), blocks, bs, scale)
        self._note_window("opus")
        t0 = time.perf_counter()
        packed = buf.cpu().numpy()
        self._stat_add("enq_opus_fetch_ms", (time.perf_counter() - t0) * 1e3)
        self._stat_add("d2h_bytes", packed.nbytes)
        return packed[:, :frame], packed[:, frame:]

    def _decode_opus_group(self, decs: List[OpusDecoder],
                           device: torch.device, to_device: bool = False):
        """CELT lockstep: the host symbol stage (C) runs a frame a lane a
        step; each (blocks, blocksize) bucket of the step then runs on the
        device (``_celt_imdct_bucket``), and the pitch postfilter and
        deemphasis (data-dependent IIRs) finish on the host in C.  Returns
        host PCM for either output, as the JAX package does."""
        B = len(decs)
        for d in decs:
            # re-probed lanes (bisect recovery) lost the eligibility stash:
            # a lane that no longer qualifies raises here, and the lattice
            # isolates it
            if not hasattr(d, "_lockstep_packets") and \
                    not self._opus_eligible(d):
                raise AudioFormatError("Opus: lane not lockstep-eligible")
        lane_frames = []
        for d in decs:
            frames = []
            for data in d._lockstep_packets:
                pk = _opus_parse(data)
                for fr in pk["frames"]:
                    frames.append((fr, pk))
            lane_frames.append(frames)
        n_steps = max(len(f) for f in lane_frames)
        outputs = [[] for _ in range(B)]
        for step in range(n_steps):
            buckets = {}
            t_host = trace.timer("parse", cpu=True)
            for bi, d in enumerate(decs):
                if step >= len(lane_frames[bi]):
                    continue
                fr, pk = lane_frames[bi][step]
                cd = d._streams[0]._celt
                n = pk["frame_size"]
                if len(fr) == 0:
                    outputs[bi].append(np.zeros((n, d.channels), np.float32))
                    continue
                endband = [13, 17, 19, 21][(pk["config"] - 16) >> 2]
                params = cd.decode_frame_symbols(
                    RangeDecoder(fr), 2 if pk["stereo"] else 1, n, 0,
                    endband)
                buckets.setdefault(
                    (params["blocks"], params["blocksize"]), []
                ).append((bi, d, cd, params, n))
            self._note_stage("host_ms", "opus", t_host)
            self._note_host_cpu("opus", t_host)
            if not buckets:
                continue
            t_enq = trace.timer("enqueue")
            for (blocks, bs), items in buckets.items():
                raw, newtail = self._celt_imdct_bucket(
                    [(cd, p) for (_, _, cd, p, _) in items], blocks, bs,
                    device)
                t0 = time.perf_counter()
                row = 0
                for (bi, d, cd, p, n) in items:
                    k = cd.output_channels
                    pcm = cd.apply_raw(raw[row: row + k].T,
                                       newtail[row: row + k].T, n)
                    row += k
                    outputs[bi].append(
                        (pcm * np.float32(d._gain) if d._gain != 1.0
                         else pcm).astype(np.float32))
                self._stat_add("enq_opus_finish_ms",
                               (time.perf_counter() - t0) * 1e3)
            self._note_stage("enqueue_ms", "opus", t_enq)
        return self._lane_pcm(decs, outputs)

    # ------------------------------ batched SILK, hybrid and mixed Opus
    @staticmethod
    def _opus_packets(d):
        """A mapping-0 stream's parsed packets for the SILK, hybrid and
        mixed groups, or None: multistream lanes, s16 parity lanes (the
        reference's output grid, a per-stream feature) and streams whose
        pages do not read take the per-stream read."""
        if d.channel_mapping != 0 or d.s16_parity:
            return None
        try:
            pkts = d._collect_packets()
        except AudioFormatError:
            return None
        parsed = [_opus_parse(data) for data in pkts]
        if not parsed or any(pk is None for pk in parsed):
            return None
        return parsed

    @staticmethod
    def _silk_eligible(d) -> bool:
        """Lockstep-eligible SILK: every packet SILK-only with no empty
        frame and one (config, stereo, frames) shape (the common VoIP
        shape), upsampled by the fitted kernels (a lane of the reference
        resampler takes another path).  Stashes the parsed packets on the
        decoder."""
        if d._reference_resampler:
            return False
        parsed = BatchDecoder._opus_packets(d)
        if parsed is None:
            return False
        key = None
        for pk in parsed:
            if pk["mode"] != "silk" or any(len(f) == 0 for f in pk["frames"]):
                return False
            k = (pk["config"], pk["stereo"], len(pk["frames"]))
            if key is None:
                key = k
            elif k != key:
                return False
        d._silk_lockstep = parsed
        return True

    @staticmethod
    def _hybrid_eligible(d) -> bool:
        """Lockstep-eligible hybrid: every packet one non-empty hybrid
        frame, with one (config, stereo), upsampled by the fitted kernels.
        Stashes the parsed packets on the decoder."""
        if d._reference_resampler:
            return False
        parsed = BatchDecoder._opus_packets(d)
        if parsed is None:
            return False
        key = None
        for pk in parsed:
            if pk["mode"] != "hybrid" or len(pk["frames"]) != 1 \
                    or len(pk["frames"][0]) == 0:
                return False
            k = (pk["config"], pk["stereo"])
            if key is None:
                key = k
            elif k != key:
                return False
        d._silk_lockstep = parsed
        return True

    @staticmethod
    def _opus_mixed_eligible(d) -> bool:
        """The mixed group takes every mapping-0 stream the other Opus
        groups decline (mode switches, mixed frame sizes, multi-frame
        hybrid): its lanes replay the per-stream read's own packet
        generator, so any stream that read decodes is eligible.  Stashes
        the parsed packets on the decoder."""
        parsed = BatchDecoder._opus_packets(d)
        if parsed is None or any(
                pk["mode"] not in ("silk", "celt", "hybrid") for pk in parsed):
            return False
        d._mixed_pkts = parsed
        return True

    def _silk_upsample_step(self, rs, X, out_max: int) -> np.ndarray:
        """One packet step of a SILK or hybrid group's upsample: every row
        of X [rows, T] through `rs` (one upload, one K13 launch, one
        download).  Returns the [rows, n] float32 48 kHz samples."""
        h0, d0 = rs.h2d_bytes, rs.d2h_bytes
        Y = rs.process(X, out_max)
        nb = rs.h2d_bytes - h0
        if nb:
            self._stat_add("h2d_bytes", nb)
            self._stat_add("h2d_bytes_by_format", nb, fmt="opus")
            self._stat_add("d2h_bytes", rs.d2h_bytes - d0)
            self._note_window("opus_silk")
        return Y

    @staticmethod
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
        out.append(tail * np.float32(d._gain) if d._gain != 1.0 else tail)

    @staticmethod
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

    def _decode_silk_group(self, decs: List[OpusDecoder], nch: int,
                           config: int, stereo: bool, nfr: int,
                           device: torch.device, to_device: bool = False):
        """SILK lockstep (the JAX package's batch.py:3247): each lane's
        SILK synthesis at the native rate on the host (the per-stream
        read's SilkDecoder), then one K13 launch a packet step upsamples
        every lane to 48 kHz.  A lane that ends drains its resampler tail
        at once (flush_row), before later steps zero-feed its rows, as the
        per-stream read drains at EOS.  Returns host PCM for either
        output, as the JAX package does."""
        B = len(decs)
        for d in decs:
            # re-probed lanes lost the eligibility stash; a still-eligible
            # lane gives the same group key
            if not hasattr(d, "_silk_lockstep") and \
                    not self._silk_eligible(d):
                raise AudioFormatError("Opus: lane not SILK-eligible")
        bw = config // 4
        dur_ms = [10, 20, 40, 60][config & 3]
        frame48 = dur_ms * 48 * nfr
        T = dur_ms * [8, 12, 16][bw] * nfr
        coded = 2 if stereo else 1
        # one warm-up a bandwidth whatever the channel count
        # (models/silk.py: the mono copy and the MS unmix share a
        # one-sample-delay timeline)
        rs = BatchedFittedUpsampler(bw, B * nch, feed=[4, 9, 12][bw],
                                    device=device)
        silks = [SilkDecoder(output_channels=nch) for _ in decs]
        outs = [[] for _ in range(B)]
        owed = [0] * B   # each lane's samples the upsampler holds back
        self._stat_add("opus_silk_lanes", B)
        for s in range(max(len(d._silk_lockstep) for d in decs)):
            t_host = trace.timer("parse", cpu=True)
            X = np.zeros((B * nch, T), np.float32)
            for bi, d in enumerate(decs):
                if s >= len(d._silk_lockstep):
                    continue
                cols = []
                for fr in d._silk_lockstep[s]["frames"]:
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
            self._note_stage("host_ms", "opus", t_host)
            self._note_host_cpu("opus", t_host)
            t_enq = trace.timer("enqueue")
            Y = self._silk_upsample_step(rs, X, frame48)
            self._note_stage("enqueue_ms", "opus", t_enq)
            for bi, d in enumerate(decs):
                if s >= len(d._silk_lockstep):
                    continue
                g = np.float32(d._gain)
                pcm = np.ascontiguousarray(Y[bi * nch: (bi + 1) * nch].T)
                outs[bi].append(pcm * g if d._gain != 1.0 else pcm)
                owed[bi] += frame48 - pcm.shape[0]
                if s == len(d._silk_lockstep) - 1:
                    self._drain_rows(d, rs, bi, outs[bi], owed[bi])
        return self._lane_pcm(decs, outs)

    def _decode_hybrid_group(self, decs: List[OpusDecoder], nch: int,
                             config: int, stereo: bool,
                             device: torch.device, to_device: bool = False):
        """Hybrid lockstep (the JAX package's batch.py:3079), a step in
        three phases.  On the host, each lane's SILK superframe at 16 kHz,
        its redundancy flag and its CELT symbols (bands 17 on, on the same
        range decoder).  On the device, one K13 launch upsamples every
        lane's SILK block and the CELT spectra run the bucketed IMDCT and
        K12a (``_celt_imdct_bucket``).  On the host again, the postfilter
        and deemphasis (apply_raw), the CELT delay FIFO and the redundancy
        paste and fade: the per-stream read's own methods.  Each lane's
        SILK delay count lives in this call, keyed by lane, so a retry
        after a demotion starts from zero with its fresh decoder.  Returns
        host PCM for either output."""
        B = len(decs)
        for d in decs:
            if not hasattr(d, "_silk_lockstep") and \
                    not self._hybrid_eligible(d):
                raise AudioFormatError("Opus: lane not hybrid-eligible")
        dur_ms = 20 if config & 1 else 10    # configs 12-15: 10 or 20 ms
        frame48 = dur_ms * 48
        T = dur_ms * 16                      # SILK runs wideband
        coded = 2 if stereo else 1
        endband = 19 if config < 14 else 21
        rs = BatchedFittedUpsampler(2, B * nch, feed=12, device=device)
        sds = []
        for d in decs:
            sd = d._streams[0]
            if sd._silk is None:
                sd._silk = SilkDecoder(output_channels=nch)
            sds.append(sd)
        delayed = [0] * B
        outs = [[] for _ in range(B)]
        self._stat_add("opus_hybrid_lanes", B)
        for st in range(max(len(d._silk_lockstep) for d in decs)):
            t_host = trace.timer("parse", cpu=True)
            X = np.zeros((B * nch, T), np.float32)
            stash = {}
            for bi, d in enumerate(decs):
                if st >= len(d._silk_lockstep):
                    continue
                sd = sds[bi]
                frame = d._silk_lockstep[st]["frames"][0]
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
            self._note_stage("host_ms", "opus", t_host)
            self._note_host_cpu("opus", t_host)
            if not stash:
                break
            t_enq = trace.timer("enqueue")
            Y = self._silk_upsample_step(rs, X, frame48)
            buckets = {}
            for bi, (params, *_) in stash.items():
                buckets.setdefault((params["blocks"], params["blocksize"]),
                                   []).append(bi)
            raws = {}
            for (blocks, bs), lanes in buckets.items():
                raw, newtail = self._celt_imdct_bucket(
                    [(sds[bi]._celt, stash[bi][0]) for bi in lanes],
                    blocks, bs, device)
                row = 0
                for bi in lanes:
                    k = sds[bi]._celt.output_channels
                    raws[bi] = (raw[row: row + k].T, newtail[row: row + k].T)
                    row += k
            self._note_stage("enqueue_ms", "opus", t_enq)
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
                g = np.float32(d._gain)
                outs[bi].append(pcm * g if d._gain != 1.0 else pcm)
                if st == len(d._silk_lockstep) - 1:
                    self._drain_rows(d, rs, bi, outs[bi], max(
                        delayed[bi], sd._celt_hyb_delay.shape[0]), sd)
        return self._lane_pcm(decs, outs)

    def _decode_opus_mixed_group(self, decs: List[OpusDecoder],
                                 device: torch.device,
                                 to_device: bool = False):
        """Mode-switching Opus lockstep (the JAX package's batch.py:2874):
        every lane drives the per-stream read's own packet generator
        (models/opus.py ``decode_packet_gen``), so SILK synthesis,
        resampler flushes, redundancy fades and the hybrid delay FIFO are
        the per-stream read's by construction.  Only the full CELT
        syntheses are answered here: from OPUS_MIXED_DEVICE_MIN_LANES
        lanes on, bucketed by (blocks, blocksize) across lanes, one K12a
        launch a bucket a round (``_celt_imdct_bucket``); in a smaller group, on the host by
        ``CeltDecoder.synthesize``, the per-stream read's own IMDCT.  Under
        a mesh the device path runs whatever the lane count, as the JAX
        package's does.  Returns host PCM for either output."""
        B = len(decs)
        use_device = self.mesh is not None or \
            B >= OPUS_MIXED_DEVICE_MIN_LANES
        for d in decs:
            if not hasattr(d, "_mixed_pkts") and \
                    not self._opus_mixed_eligible(d):
                raise AudioFormatError("Opus: lane not mixed-eligible")
        outs = [[] for _ in range(B)]
        gens = [None] * B     # each lane's live decode_packet_gen
        nexts = [0] * B       # each lane's next packet
        sends = [None] * B    # each lane's pending synthesis answer
        sds = [d._streams[0] for d in decs]
        done = [False] * B
        self._stat_add("opus_mixed_lanes", B)
        while not all(done):
            t_host = trace.timer("parse", cpu=True)
            jobs = {}
            for bi, d in enumerate(decs):
                while not done[bi]:
                    if gens[bi] is None:
                        if nexts[bi] >= len(d._mixed_pkts):
                            done[bi] = True
                            break
                        gens[bi] = sds[bi].decode_packet_gen(
                            d._mixed_pkts[nexts[bi]])
                        nexts[bi] += 1
                        sends[bi] = None
                    try:
                        cd, params = gens[bi].send(sends[bi])
                    except StopIteration as e:
                        pcm = e.value
                        outs[bi].append(pcm * np.float32(d._gain)
                                        if d._gain != 1.0 else pcm)
                        gens[bi] = sends[bi] = None
                        continue
                    jobs.setdefault((params["blocks"], params["blocksize"]),
                                    []).append((bi, cd, params))
                    break
            if jobs and not use_device:
                for items in jobs.values():
                    for bi, cd, p in items:
                        sends[bi] = cd.synthesize(p)
                self._stat_add("opus_mixed_host_rounds", 1)
            self._note_stage("host_ms", "opus", t_host)
            self._note_host_cpu("opus", t_host)
            if not jobs or not use_device:
                continue
            t_enq = trace.timer("enqueue")
            for (blocks, bs), items in jobs.items():
                raw, newtail = self._celt_imdct_bucket(
                    [(cd, p) for _, cd, p in items], blocks, bs, device)
                row = 0
                for bi, cd, p in items:
                    k = cd.output_channels
                    sends[bi] = cd.apply_raw(raw[row: row + k].T,
                                             newtail[row: row + k].T,
                                             p["frame_size"])
                    row += k
            self._note_stage("enqueue_ms", "opus", t_enq)
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
                outs[bi].append(tail * np.float32(d._gain)
                                if d._gain != 1.0 else tail)
        return self._lane_pcm(decs, outs)
