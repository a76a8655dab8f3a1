"""BatchDecoder — batched lockstep decode with PyTorch device stages.

N independent compressed streams decode in lockstep: the lanes of one
format and shape form a group, which runs its host stage a window of
frames at a time, then one upload and one chain of device work a window
(``groups/``, one module a format family; what they share is
``window.py``).  This module runs the groups: it cuts each into chunks of
the group width and shards of the mesh (``mesh.py``), runs them, demotes
faulty lanes, and reads the lanes no group takes (MOD, XM, float WAV,
multistream Opus) a stream at a time on the host.

Error lattice: a corrupt stream only poisons its own lane — it stops
producing frames and its `errors` entry is set; other lanes are unaffected.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import models, trace
from ..device import device_of
from ..errors import AudioFormatError
from ..host import native as _native
from ..io.source import ByteSource, FileSource, MemorySource
from ..ops._kernels import KernelError
from . import groups
from .mesh import mesh_device
from .window import GroupContext, Stats, _PendingGroup


def _format_name(dec) -> str:
    """A decoder's format as stats names it ("mp3", "flac", ...)."""
    return type(dec).__name__.replace("Decoder", "").lower()


def _open_source(item) -> ByteSource:
    if isinstance(item, (bytes, bytearray, memoryview)):
        return MemorySource(item)
    return FileSource(item)


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
        for _, fmt, g in finalizers:
            owner._stats.add("decoded_seconds", g.seconds, fmt)
        for i, v in enumerate(out):
            if isinstance(v, np.ndarray):
                owner._note_lane_seconds(i, v)

    def windows(self):
        return [
            (fmt, [p[0] for p in g.pending]) for _, fmt, g in self._finalizers
        ]

    def sync(self):
        """Block until every device the batch used has finished its work."""
        with trace.root("sync", call=self._owner._trace_call):
            for dev in self._owner.devices_used:
                _synchronize(dev)
        return self

    def to_numpy(self):
        out = list(self._out)
        for chunk, _, g in self._finalizers:
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
        self._stats = Stats(len(items))
        #: decoded seconds, per-stage host and enqueue ms, bytes each way,
        #: device windows (each also by format; ``window.py`` says what
        #: each counts), demotions and the exceptions behind them
        self.stats = self._stats.values

    def _note_lane_seconds(self, i: int, pcm: np.ndarray):
        """The seconds of lane i's host PCM, under its decoder's format."""
        d = self.decoders[i]
        if d is not None:
            self._stats.add("decoded_seconds",
                            pcm.shape[0] / max(1, d.sample_rate),
                            _format_name(d))

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

    def _run_group(self, fn, chunk, key, ctx: GroupContext):
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
        call, retries included, runs on the shard's device.  With numpy
        output a pending group is downloaded here, inside the lattice."""
        try:
            res = fn(ctx, [self.decoders[i] for i in chunk], key)
            if isinstance(res, _PendingGroup) and not ctx.to_device:
                res = res.finalize()
            return res
        except KernelError:
            raise
        except Exception as e:
            self._stats.fault(e)
            if len(chunk) == 1:
                self._stats.add("lanes_demoted", 1)
                self._reprobe(chunk[0], ctx.device)
                return [None]
            mid = len(chunk) // 2
            out = []
            for half in (chunk[:mid], chunk[mid:]):
                for i in half:
                    self._reprobe(i, ctx.device)
                live = [i for i in half if self.decoders[i] is not None]
                res = {i: None for i in half}
                if live:
                    sub = self._run_group(fn, live, key, ctx)
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

        # each lane to the first entry that keys it
        table = groups.TABLE
        keyed = [{} for _ in table]
        for i, d in enumerate(self.decoders):
            if d is None:
                continue
            for e, by_key in zip(table, keyed):
                key = e.key(d)
                if key is not None:
                    by_key.setdefault(key, []).append(i)
                    break

        # lockstep group width: with device-resident output the whole batch
        # can ride one group (no per-window PCM download); when PCM is
        # downloaded, moderate groups let fetches overlap the next group's
        # host stage
        GROUP = self._group_size or (1024 if to_device else 256)
        data_devices = [self.device] if self.mesh is None \
            else self.mesh.data_devices
        # (entry, key, lanes, device) of each non-empty shard of every
        # GROUP chunk of each group: a chunk splits into contiguous pieces
        # over the data devices
        jobs = {groups.POOL: [], groups.AFTER: [], groups.THREAD: []}
        for e, by_key in zip(table, keyed):
            for key, lanes in by_key.items():
                for c in range(0, len(lanes), GROUP):
                    chunk = lanes[c: c + GROUP]
                    for dev, idx in zip(data_devices, np.array_split(
                            np.arange(len(chunk)), len(data_devices))):
                        if idx.size:
                            jobs[e.schedule].append(
                                (e, key, chunk[idx[0]: idx[-1] + 1], dev))
                            if dev not in self.devices_used:
                                self.devices_used.append(dev)

        def run(e, key, chunk, device):
            gctx = GroupContext(self._stats, device, to_device,
                                self.flac_wire, self.mesh is not None)
            with trace.span("group", ctx=ctx, lanes=len(chunk),
                            device=str(device), format=e.name):
                res = self._run_group(e.decode, chunk, key, gctx)
            if isinstance(res, _PendingGroup):
                finalizers.append((chunk, e.format, res))
                for i in chunk:
                    out[i] = res  # placeholder: resolved by to_numpy()
            else:
                for i, pcm in zip(chunk, res):
                    out[i] = pcm

        # the mode-switching Opus group runs on a thread of its own, beside
        # the other groups; it is joined even when another group raises,
        # so no orphaned thread goes on writing `out`, and its own
        # exception is raised here on the main thread
        mixed_thread = None
        mixed_err = []
        if jobs[groups.THREAD]:
            def run_mixed():
                try:
                    for job in jobs[groups.THREAD]:
                        run(*job)
                except BaseException as e:  # raised on the main thread
                    mixed_err.append(e)

            mixed_thread = threading.Thread(target=run_mixed,
                                            name="af-opus-mixed")
            mixed_thread.start()
        try:
            # groups run concurrently on multi-core hosts (lane sets are
            # disjoint; stats ride the sink's lock): one group's host
            # parse overlaps another group's uploads and device windows
            # (under a mesh too: the shards share no collective whose
            # order the threads could break)
            pooled = jobs[groups.POOL]
            conc = 2 if (os.cpu_count() or 1) > 1 else 1
            if conc > 1 and len(pooled) > 1:
                with ThreadPoolExecutor(max_workers=conc,
                                        thread_name_prefix="af-group") as ex:
                    for f in [ex.submit(run, *job) for job in pooled]:
                        f.result()
            else:
                for job in pooled:
                    run(*job)
            for job in jobs[groups.AFTER]:
                run(*job)
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
            if pcm is not None:
                self._note_lane_seconds(i, pcm)
        return out
