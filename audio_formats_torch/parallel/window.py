"""What the lockstep groups of ``BatchDecoder`` share: the uploads and
PCM prefetch, the stats sink, a group's context, the pending group whose
PCM is still on the device, and the window loop of the pooled groups
(MP3 Layer III, FLAC on either wire).

Each bookkeeping step is one call of the ``Stats`` sink, so what each
counter covers is written once, here: a parse stage's wall goes to
``host_ms`` and its thread CPU to ``host_cpu_ms`` (a parse pool's chunks
each add their own); an enqueue stage's wall, from a parsed window to
its device work handed over, to ``enqueue_ms`` (for the window loop's
groups the window's assembly and the submit to the dispatch worker,
whose upload and launch only spans time; for the others the upload and
launch themselves); a window adds one to ``windows`` and its bytes to
``h2d_bytes``; a download its bytes to ``d2h_bytes`` and its wait to
``fetch_ms``.  Each also splits by format (``<name>_by_format``).  Wall
counters sum the walls of groups that run concurrently.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import trace
from ..host import native as _native


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


def _lane_bytes(decs):
    """Each lane's stream bytes for the C stage's multi-lane entries,
    which find a lane's bytes by its row: (keepalives, which must outlive
    every C call that reads the bytes, addresses uint64, lengths int64)."""
    views = [_native.buf_addr(d._view) for d in decs]
    return (views, np.array([v[0] for v in views], np.uint64),
            np.array([v[1] for v in views], np.int64))


def _lane_chunks(lanes, n_workers):
    """Contiguous lane chunks for the parse pool: ~4 chunks per worker
    rides out variable per-lane parse cost without paying per-lane task
    dispatch overhead.  Order-preserving so chunked results zip back
    against the live-lane list."""
    n = max(1, -(-len(lanes) // max(1, n_workers * 4)))
    return [lanes[i: i + n] for i in range(0, len(lanes), n)]


#: the wall counter of each timed stage (a parse pool's chunks count only
#: their thread CPU)
_WALL = {"parse": "host_ms", "enqueue": "enqueue_ms", "parse_chunk": None}


class Stats:
    """``BatchDecoder.stats`` (``values``) and the lock its groups, which
    may run concurrently, update it under: a bare ``+=`` on a dict entry
    is a read-modify-write race."""

    def __init__(self, lanes: int):
        self._lock = threading.Lock()
        self.values = {
            "decoded_seconds": 0.0,
            "decoded_seconds_by_format": {},
            "lanes": lanes,
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

    def add(self, key: str, val, fmt: str = None):
        """Add `val` to `key` and, with `fmt`, to its split by format."""
        with self._lock:
            self.values[key] = self.values.get(key, 0) + val
            if fmt is not None:
                by = self.values[key + "_by_format"]
                by[fmt] = by.get(fmt, 0) + val

    def most(self, key: str, val):
        """Raise `key` to `val` where it is lower."""
        with self._lock:
            self.values[key] = max(val, self.values[key])

    def fault(self, e: BaseException):
        """A group run that raised: counted, and its exception kept (the
        first 32), so code faults don't masquerade as corrupt data."""
        with self._lock:
            self.values["group_demotions"] += 1
            excs = self.values.setdefault("group_exceptions", [])
            if len(excs) < 32:
                excs.append(f"{type(e).__name__}: {e}")

    @contextlib.contextmanager
    def stage(self, name: str, fmt: str, cpu: bool = False, **attrs):
        """Time a stage on this thread, a span of `name` while the tracer
        is on: its wall to the stage's counter (``_WALL``) and, with `cpu`,
        its thread CPU to host_cpu_ms."""
        t = trace.timer(name, cpu=cpu, **attrs)
        try:
            yield
        finally:
            t.stop()
            t.set(format=fmt)
            if _WALL[name] is not None:
                self.add(_WALL[name], t.ms, fmt)
            if cpu:
                self.add("host_cpu_ms", t.cpu_ms, fmt)

    def window(self, fmt: str, h2d: int = None, h2d_fmt: str = None):
        """One device window of `fmt`, and the `h2d` bytes it uploaded
        (under `h2d_fmt`, `fmt` by default), where it counts them."""
        self.add("windows", 1, fmt)
        if h2d is not None:
            self.add("h2d_bytes", h2d, h2d_fmt or fmt)

    def fetched(self, pending):
        """Download each pending window (a tuple, its device PCM or host
        copy first): its bytes to d2h_bytes, its wait to fetch_ms.
        Yields (numpy PCM, the rest of the tuple...)."""
        for out, *rest in pending:
            t0 = time.perf_counter()
            arr = _to_numpy(out)
            self.add("fetch_ms", (time.perf_counter() - t0) * 1e3)
            self.add("d2h_bytes", arr.nbytes)
            yield (arr, *rest)


@dataclasses.dataclass(frozen=True)
class GroupContext:
    """What a group's decode function is given beside its lanes and key:
    the stats sink, the shard's device, whether the PCM stays there
    (``output="device"``), the FLAC wire and whether the batch runs over
    a mesh."""

    stats: Stats
    device: torch.device
    to_device: bool
    flac_wire: str
    sharded: bool


class _PendingGroup:
    """A lockstep group whose PCM windows are still on the device:
    `pending` holds a tuple a window, its PCM tensor first; `seconds` is
    the audio the group decoded.  ``finalize()`` downloads and assembles
    the per-lane numpy PCM (cached)."""

    def __init__(self, pending, fin, seconds: float):
        self.pending = pending
        self.seconds = seconds
        self._fin = fin
        self._result = None

    def finalize(self):
        if self._result is None:
            self._result = self._fin()
        return self._result


class WindowLoop:
    """The window loop of a pooled group, as a context manager: the parse
    pool (``af-parse``, up to 8 threads, made at its first use) and one
    dispatch worker (``af-dispatch``: window t+1's parse overlaps window
    t's upload and device chain), and the spans ``window``, ``parse``,
    ``parse_chunk``, ``enqueue`` and ``wait`` with their stats.  On any
    exit, a lane fault raising out of the loop included, the group
    thread waits for the dispatch worker's last windows and both pools
    shut down, so no worker outlives the group."""

    def __init__(self, stats: Stats, fmt: str):
        self.stats = stats
        self.fmt = fmt
        self.n_workers = max(1, min(8, os.cpu_count() or 1))
        self._parse = None
        self._dispatch = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="af-dispatch")
        #: the open window span's context, for the workers' spans
        self.ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            with trace.span("wait", format=self.fmt):
                self._dispatch.shutdown(wait=True)
        finally:
            if self._parse is not None:
                self._parse.shutdown(wait=True)
        return False

    @contextlib.contextmanager
    def window(self, k: int, **attrs):
        """Window `k`'s span, the parent of its steps."""
        with trace.span("window", format=self.fmt, window=k, **attrs):
            self.ctx = trace.context()
            yield

    def stage(self, name: str, cpu: bool = False):
        """The window's "parse" or "enqueue" stage on the group's thread
        (``Stats.stage``); a parse that runs the pool counts its chunks'
        thread CPU, one that does not (`cpu`) its own."""
        return self.stats.stage(name, self.fmt, cpu=cpu)

    def map(self, fn, lanes):
        """``fn(chunk)`` over contiguous chunks of `lanes` on the parse
        pool (on this thread with one core), each chunk a ``parse_chunk``
        stage; the chunks' lists joined in lane order."""
        if self.n_workers == 1:
            return self._chunk(fn, lanes)
        if self._parse is None:
            self._parse = ThreadPoolExecutor(
                max_workers=self.n_workers, thread_name_prefix="af-parse")
        return [r for sub in self._parse.map(
            lambda c: self._chunk(fn, c),
            _lane_chunks(lanes, self.n_workers)) for r in sub]

    def _chunk(self, fn, lanes):
        with self.stats.stage("parse_chunk", self.fmt, cpu=True,
                              ctx=self.ctx, lanes=len(lanes)):
            return fn(lanes)

    def submit(self, fn, *args):
        """``fn(*args)`` on the dispatch worker; its future."""
        return self._dispatch.submit(fn, *args)

    def wait(self, fut, **attrs):
        """The result of `fut`, the group thread blocked in a ``wait``
        span."""
        with trace.span("wait", format=self.fmt, **attrs):
            return fut.result()
