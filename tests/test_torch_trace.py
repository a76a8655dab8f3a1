"""The port's tracer (audio_formats_torch/trace.py) on the CPU.

Off, it records nothing and hands out one shared no-op span.  On, a
batch of golden MP3 streams and one of golden FLAC streams each give
every window its parse, pack, upload and launch spans; the spans of the
parse pool and the dispatch worker name their window as parent, run on
the named threads and share the call's id; the parse spans add up to
``stats["host_ms"]``, the window spans to ``stats["windows"]`` and the
upload spans' bytes to ``stats["h2d_bytes"]``; the PCM is bit-equal with
the tracer on and off; and under a CPU ``torch.profiler`` each root span
lands within 1 ms of its profiler range once the clocks are fitted.
"""

import gc
import os

import numpy as np
import pytest

from audio_formats_torch import BatchDecoder, trace
from audio_formats_torch.host import native

from golden import flac_ref
from test_torch_mp3_huff import mp3_stream

#: the spans every window of the MP3 and packed FLAC paths has
WINDOW_STEPS = {"parse", "pack", "upload", "launch"}
ROOTS = ("construct", "decode_all", "sync")


@pytest.fixture
def tracer():
    """The tracer on for the test, then off and empty."""
    trace.drain()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.drain()


def _mp3_items():
    # 60 frames: three windows of 24
    return [mp3_stream(seed, n_frames=60) for seed in (3, 4)]


def _flac_items():
    rng = np.random.default_rng(7)
    items = []
    for frames in (30000, 26000, 12000):
        pcm = np.round(3000 * rng.standard_normal((frames, 2)))\
            .astype(np.int64)
        items.append(flac_ref.build_flac(
            pcm, 44100, 16, block_size=1024, stereo_mode="mid_side",
            modes=["lpc8", "fixed3"]))
    return items


CASES = {"mp3": _mp3_items, "flac": _flac_items}


def _decode(items):
    dec = BatchDecoder(items, device="cpu")
    pcm = dec.decode_all(output="device").sync().to_numpy()
    return dec, pcm


def _ms(s):
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def test_off_records_nothing():
    trace.drain()
    assert trace.span("a") is trace.span("b", ctx=(1, 2), x=1)
    assert trace.root("construct") is trace.NOOP
    assert trace.context() is None and trace.new_call() is None
    t = trace.timer("parse", cpu=True)
    assert not isinstance(t, trace.Span)
    assert t.stop().ms >= 0 and t.cpu_ms >= 0
    _decode(_mp3_items()[:1])
    gc.collect()
    out = trace.drain()
    assert out == {"spans": [], "anchors": [], "dropped": 0}


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_each_window_has_its_steps(tracer, fmt):
    dec, _ = _decode(CASES[fmt]())
    spans = tracer.drain()["spans"]
    by_id = {s["id"]: s for s in spans}

    def window_of(s):
        while s is not None and s["name"] != "window":
            s = by_id.get(s["parent"])
        return s

    windows = [s for s in spans if s["name"] == "window"]
    assert len(windows) == dec.stats["windows"] >= 2
    for w in windows:
        steps = {s["name"] for s in spans
                 if s is not w and window_of(s) is w}
        assert WINDOW_STEPS <= steps, (w["attrs"], steps)
        assert w["attrs"]["format"] == fmt


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_worker_spans_name_their_window_and_call(tracer, fmt):
    _decode(CASES[fmt]())
    spans = tracer.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    calls = {s["call"] for s in spans if s["name"] in ROOTS}
    assert len(calls) == 1
    call = calls.pop()
    pooled = (os.cpu_count() or 1) > 1
    workers = {"parse_chunk": "af-parse" if pooled else "MainThread",
               "upload": "af-dispatch", "launch": "af-dispatch"}
    if fmt == "flac":
        workers["pack"] = "af-dispatch"
    for s in spans:
        if s["name"] == "runtime.gc":
            continue
        assert s["call"] == call, s
        if s["name"] in workers:
            assert s["thread_name"].startswith(workers[s["name"]]), s
            assert by_id[s["parent"]]["name"] == "window", s
            if s["name"] != "parse_chunk":
                assert s["attrs"]["window"] == \
                    by_id[s["parent"]]["attrs"]["window"]
        assert s["end_ns"] >= s["start_ns"] and s["cpu_ns"] >= 0
    names = {s["name"] for s in spans}
    assert {"construct", "probe", "decode_all", "group", "wait",
            "sync"} <= names
    probes = [s for s in spans if s["name"] == "probe"]
    assert {p["attrs"]["format"] for p in probes} == {fmt}


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_spans_agree_with_stats(tracer, fmt):
    dec, _ = _decode(CASES[fmt]())
    spans = tracer.drain()["spans"]
    st = dec.stats

    def total(name):
        return sum(_ms(s) for s in spans if s["name"] == name)

    assert total("parse") == pytest.approx(st["host_ms"], rel=1e-9)
    assert total("enqueue") == pytest.approx(st["enqueue_ms"], rel=1e-9)
    cpu = sum(s["cpu_ns"] for s in spans if s["name"] == "parse_chunk")
    assert cpu * 1e-6 == pytest.approx(st["host_cpu_ms"], rel=1e-9)
    assert sum(s["name"] == "window" for s in spans) == st["windows"]
    assert sum(s["attrs"]["bytes"] for s in spans
               if s["name"] == "upload") == st["h2d_bytes"]
    # the pack counters the pack spans replaced
    assert not {"enq_mp3_pack_ms", "enq_flacp_pack_ms"} & set(st)


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_pcm_is_the_same_with_the_tracer_on(fmt):
    items = CASES[fmt]()
    _, off = _decode(items)
    trace.enable()
    try:
        _, on = _decode(items)
    finally:
        trace.disable()
        trace.drain()
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_root_spans_land_on_their_profiler_ranges(tracer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(_mp3_items())
    out = tracer.drain()
    twins = {}
    for e in prof.events():
        sid = trace.range_id(e.name)
        if sid is not None:
            twins[sid] = (e.time_range.start * 1e3, e.time_range.end * 1e3)
    roots = {s["id"]: s for s in out["spans"] if s["name"] in ROOTS}
    assert len(roots) == 3 and set(roots) == set(twins)
    assert {sid for _, sid in out["anchors"]} == set(roots)
    off, spread = trace.fit_offset(out["anchors"],
                                   {k: v[0] for k, v in twins.items()})
    assert spread < 1e6
    for sid, s in roots.items():
        assert abs(s["start_ns"] + off - twins[sid][0]) < 1e6
        assert abs(s["end_ns"] + off - twins[sid][1]) < 1e6


def test_collections_become_spans(tracer):
    with trace.span("outer") as outer:
        gc.collect()
    spans = tracer.drain()["spans"]
    runs = [s for s in spans if s["name"] == "runtime.gc"]
    assert any(s["attrs"]["generation"] == 2 and s["parent"] == outer.sid
               for s in runs)


def test_full_buffer_counts_what_it_drops(tracer, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    gc.disable()
    try:
        for i in range(8):
            with trace.span("s", i=i):
                pass
    finally:
        gc.enable()
    out = tracer.drain()
    assert [s["attrs"]["i"] for s in out["spans"]] == list(range(5))
    assert out["dropped"] == 3


def test_spans_nest_and_a_span_left_open_is_closed_by_its_parent(tracer):
    with trace.span("a") as a:
        left_open = trace.timer("left_open")
        with trace.span("b", ctx=(99, 7)) as b:
            pass
        inner = trace.span("c")
        inner.stop()
    assert trace.context() is None
    spans = {s["name"]: s for s in tracer.drain()["spans"]}
    assert set(spans) == {"a", "b", "c"}
    assert spans["b"]["parent"] == 99 and spans["b"]["call"] == 7
    assert spans["a"]["parent"] is None
    assert spans["c"]["parent"] == left_open.sid
    assert b.sid != a.sid


def test_host_stage_load_is_a_span(tracer, monkeypatch):
    if native.get_lib() is None:
        pytest.skip("the C host stage did not build here")
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is not None
    loads = [s for s in tracer.drain()["spans"] if s["name"] == "kernel.load"]
    assert [s["attrs"]["kernel"] for s in loads] == ["af_host"]


def test_threads_lose_no_span(tracer):
    """More threads than cores open nested spans at once, with a short
    switch interval: every span is kept once, under its own parent."""
    import sys
    import threading

    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 300
    errors = []

    def work(i):
        try:
            with trace.span("outer", thread_no=i) as outer:
                for j in range(n_spans):
                    with trace.span("inner", i=j) as inner:
                        assert inner.parent == outer.sid
            assert trace.context() is None
        except AssertionError as e:   # reported on the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = [s for s in tracer.drain()["spans"] if s["name"] != "runtime.gc"]
    assert len(spans) == n_threads * (n_spans + 1)
    assert len({s["id"] for s in spans}) == len(spans)
    outers = {s["id"]: s for s in spans if s["name"] == "outer"}
    for s in spans:
        if s["name"] == "inner":
            assert outers[s["parent"]]["thread"] == s["thread"]
