"""Spans of the port's host work, kept in memory while the tracer is on.

The tracer is off by default.  ``span()`` then costs one check of a
module global and returns one shared no-op context manager: it reads no
clock and records nothing.  ``enable()`` turns it on, ``drain()`` hands
over what it kept and empties the buffer, ``disable()`` turns it off.

While it is on, each span keeps its name, its start and end on
``time.perf_counter_ns``, its thread's id and name, the thread CPU time it
took (``time.thread_time_ns``), its own id, its parent's id, its call's id
(one a ``BatchDecoder``, shared by the call's spans on every thread) and
its attributes (format, window, lanes, bytes, launches...).  Every garbage
collection becomes a ``runtime.gc`` span with its generation.  The buffer
keeps at most ``CAP`` records and counts those it drops.

A span's parent is the span open on its thread.  Work handed to another
thread takes its parent along: the submitting code reads ``context()``
and the worker passes it on, ``span(name, ctx=...)``.

The root spans of a call (``root()``: ``construct``, ``decode_all``,
``sync``) are also opened as ``torch.profiler`` ranges named
``af.<name>#<id>``, and ``drain()`` returns each one's start beside its
id (``anchors``), so a reader can fit the offset from ``perf_counter_ns``
to the profiler's clock (``fit_offset``).

``timer()`` is the stage timer behind ``BatchDecoder.stats``: it always
measures, and while the tracer is on it is a span as well, so a stage's
``stats`` entry and its spans come from the same two clock reads.
"""

from __future__ import annotations

import gc
import itertools
import statistics
import threading
import time

#: most records the buffer keeps; later ones are counted as dropped
CAP = 1 << 20
#: prefix of the profiler ranges that root spans open
RANGE_PREFIX = "af."

_on = False
#: reentrant: a collection that starts inside a locked section (an
#: allocation there) records its span on the same thread
_lock = threading.RLock()
_records = []
_anchors = []
_dropped = 0
_ids = itertools.count(1)
_calls = itertools.count(1)
_tls = threading.local()


class _NoSpan:
    """What span() and root() return while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _NoSpan()


class Timer:
    """A wall clock, and with ``cpu`` the thread's CPU clock, read at
    creation and at the first ``stop()``."""

    __slots__ = ("t0", "t1", "c0", "c1")

    def __init__(self, cpu: bool = False):
        self.c0 = time.thread_time_ns() if cpu else None
        self.c1 = None
        self.t0 = time.perf_counter_ns()
        self.t1 = None

    def stop(self):
        if self.t1 is None:
            self.t1 = time.perf_counter_ns()
            if self.c0 is not None:
                self.c1 = time.thread_time_ns()
        return self

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def cpu_ms(self) -> float:
        return (self.c1 - self.c0) * 1e-6

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _thread():
    """(open spans, id, name) of this thread."""
    me = getattr(_tls, "me", None)
    if me is None:
        th = threading.current_thread()
        me = _tls.me = ([], th.ident, th.name)
    return me


def _emit(rec) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


class Span(Timer):
    """A timer that is recorded when it stops (the tracer is on)."""

    __slots__ = ("name", "sid", "parent", "call", "attrs", "tid", "tname",
                 "_range")

    def __init__(self, name: str, ctx, call, attrs: dict, range_=False):
        st, self.tid, self.tname = _thread()
        if ctx is None and st:
            ctx = (st[-1].sid, st[-1].call)
        self.name = name
        self.sid = next(_ids)
        self.parent, self.call = ctx if ctx is not None else (None, call)
        self.attrs = attrs
        self._range = None
        st.append(self)
        self.c1 = self.t1 = None
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        if range_:
            from torch.autograd.profiler import record_function
            self._range = record_function(f"{RANGE_PREFIX}{name}#{self.sid}")
            self._range.__enter__()
            with _lock:
                _anchors.append((self.t0, self.sid))

    def set(self, **attrs):
        self.attrs.update(attrs)

    def stop(self):
        if self.t1 is not None:
            return self
        self.t1 = time.perf_counter_ns()
        self.c1 = time.thread_time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        st = _thread()[0]
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            # a span left open by an exception is closed by its parent
            del st[st.index(self):]
        _emit((self.name, self.t0, self.t1, self.tid, self.tname,
               self.c1 - self.c0, self.sid, self.parent, self.call,
               self.attrs))
        return self


def span(name: str, ctx=None, **attrs):
    """A span of `name` under the span open on this thread, or under
    `ctx` (``context()`` read on the thread that handed the work over)."""
    if not _on:
        return NOOP
    return Span(name, ctx, None, attrs)


def root(name: str, call=None, **attrs):
    """A span that begins a step of call `call` (``new_call()``), also
    opened as a profiler range."""
    if not _on:
        return NOOP
    return Span(name, (None, call if call is not None else next(_calls)),
                None, attrs, range_=True)


def timer(name: str, cpu: bool = False, ctx=None, **attrs) -> Timer:
    """A stage timer: a span of `name` while the tracer is on, else a
    bare Timer (with the thread's CPU clock if `cpu`)."""
    if not _on:
        return Timer(cpu)
    return Span(name, ctx, None, attrs)


def context():
    """(span id, call id) of the span open on this thread, to hand to
    work submitted elsewhere; None while the tracer is off or no span is
    open."""
    if not _on:
        return None
    st = _thread()[0]
    return (st[-1].sid, st[-1].call) if st else None


def new_call():
    """A fresh call id (None while the tracer is off)."""
    return next(_calls) if _on else None


def _gc_callback(phase, info):
    if phase == "start":
        _tls.gc = (time.perf_counter_ns(), time.thread_time_ns())
        return
    began = getattr(_tls, "gc", None)
    if began is None:
        return
    _tls.gc = None
    t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
    st, tid, tname = _thread()
    parent, call = (st[-1].sid, st[-1].call) if st else (None, None)
    _emit(("runtime.gc", began[0], t1, tid, tname, c1 - began[1],
           next(_ids), parent, call, {"generation": info["generation"]}))


def enable() -> None:
    """Turn the tracer on (and record the garbage collector)."""
    global _on
    with _lock:
        if not _on:
            gc.callbacks.append(_gc_callback)
            _on = True


def disable() -> None:
    """Turn the tracer off; what it kept stays until drain()."""
    global _on
    with _lock:
        if _on:
            gc.callbacks.remove(_gc_callback)
            _on = False


_FIELDS = ("name", "start_ns", "end_ns", "thread", "thread_name", "cpu_ns",
           "id", "parent", "call", "attrs")


def drain() -> dict:
    """What the tracer kept since the last drain, and empty it:
    ``spans`` (dicts of name, start_ns, end_ns, thread, thread_name,
    cpu_ns, id, parent, call, attrs, in the order they ended),
    ``anchors`` ((perf_counter_ns start, span id) of each root span) and
    ``dropped`` (records the full buffer refused)."""
    global _records, _anchors, _dropped
    with _lock:
        recs, anchors, dropped = _records, _anchors, _dropped
        _records, _anchors, _dropped = [], [], 0
    return {"spans": [dict(zip(_FIELDS, r)) for r in recs],
            "anchors": anchors, "dropped": dropped}


def range_id(range_name: str):
    """The span id in a profiler range's name, or None for a range that
    no root span opened."""
    if not range_name.startswith(RANGE_PREFIX) or "#" not in range_name:
        return None
    tail = range_name.rsplit("#", 1)[1]
    return int(tail) if tail.isdigit() else None


def fit_offset(anchors, twin_starts_ns: dict):
    """(offset, spread) in ns from perf_counter_ns to another clock:
    the median of (twin start - anchor start) over the root spans whose
    profiler range was seen (`twin_starts_ns`: span id -> start on that
    clock), and the largest distance of one pair from it.  None where no
    pair matches."""
    d = [twin_starts_ns[sid] - t0 for t0, sid in anchors
         if sid in twin_starts_ns]
    if not d:
        return None
    off = statistics.median(d)
    return off, max(abs(x - off) for x in d)
