"""The benchmark of audio_formats_torch: one run of one cell.

A cell names a configuration (``configs/<config>.json``: the stream format
and the deployment it stands for) and a traffic mix
(``traffic/<mix>.json``: the call, the batch, the length law).
The run generates a seeded pool of streams (``gen/<format>.py``), warms
the program up, then, for ``seconds``, makes calls (``calls/<call>.py``)
in a closed loop with one client: each call's batch drawn from the pool,
the next call made once the last one's output is on the card.  Each
metric is read from the run by its own file (``metrics/<name>.py``).
After the window a seeded sample of what the timed calls produced is
downloaded and compared with the format's plain reference
(``ref/<format>.py``): that decides ``correct``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import time

import numpy as np

from . import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_formats_tpu")
#: timed calls whose output is kept for the comparison (a seeded
#: reservoir sample; the configuration says how many of their lanes)
KEEP_CALLS = 3
WARMUP_CALLS = 2
#: a traced run traces the first calls of its window, up to this long: the
#: trace of a whole window takes longer to read than a run may last
TRACE_SECONDS = 10.0
#: the keys of a traffic file: one client in a closed loop is the only
#: loop the harness runs, so a file names no other
TRAFFIC_KEYS = {"call", "batch", "lengths"}
#: resource usage a call record keeps (--calls-out): CPU by mode, page
#: faults and context switches (0 where the kernel does not count them)
RUSAGE = ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt", "ru_nvcsw",
          "ru_nivcsw")


def process_start() -> float:
    """This process's start on time.monotonic's clock (Linux: from
    /proc), so that set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader of metric `name`: metrics/<name>.py's ``value(run)``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str):
    """(cell, configuration, traffic, end-to-end metrics, per-layer
    metrics) of the workload named in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(conf["file"])
    traffic = load_json(os.path.join("portbench", "traffic",
                                     cell["traffic"] + ".json"))
    if set(traffic) != TRAFFIC_KEYS:
        raise SystemExit(f"traffic {cell['traffic']!r}: keys "
                         f"{sorted(traffic)}, the harness reads "
                         f"{sorted(TRAFFIC_KEYS)}")

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, cfg, traffic, e2e, layer


class Collections:
    """Host-clock time that Python's garbage collector takes while it is
    on, and the number of full (generation 2) collections."""

    def __init__(self):
        self.s, self.full, self._t0 = 0.0, 0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def start(self):
        gc.callbacks.append(self._cb)
        return self

    def stop(self):
        gc.callbacks.remove(self._cb)


class Spans:
    """The benchmark's own spans: host-clock durations of each step of a
    call, and, while tracing, a profiler range of the same name."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function
            with record_function(name):
                yield
        else:
            yield
        self.ms[name] = (time.perf_counter() - t0) * 1e3


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             tracing: bool, device: str = "cuda", t_start: float = None,
             metrics=(), control: bool = False):
    """One run: returns the result's fields (metrics by name, checks).
    With `control`, also the number the control reads on the same lanes
    (the reference one precision lower in the program's place)."""
    t_start = time.monotonic() if t_start is None else t_start
    gen = importlib.import_module("portbench.gen." + cfg["format"])
    ref = importlib.import_module("portbench.ref." + cfg["format"])
    call = importlib.import_module("portbench.calls." + traffic["call"])
    ss = np.random.SeedSequence(int(seed))
    rng_gen, rng_draw, rng_keep = (np.random.default_rng(s)
                                   for s in ss.spawn(3))
    corpus = gen.build(cfg, traffic, rng_gen)
    pool = corpus.streams
    B = int(traffic["batch"])
    if B > len(pool):
        raise ValueError("the batch is larger than the pool")

    def draw():
        return rng_draw.choice(len(pool), size=B, replace=False)

    quiet = Spans(False)
    for _ in range(WARMUP_CALLS):
        res, _, _ = call.run([pool[i] for i in draw()], device, quiet)
        del res
    _sync(device)
    setup_s = time.monotonic() - t_start
    # set-up's garbage goes before the window; the collector then runs at
    # its defaults, as in a loader, and its time is measured
    gc.collect()

    spans = Spans(tracing)
    if tracing:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    # an end-to-end metric on the device's clock: the card's operations
    # over the whole window, traced alone (no host events)
    clock = None
    if not tracing and device.startswith("cuda") and any(
            m.get("source") == "device_trace" for m in metrics):
        from torch.profiler import ProfilerActivity, profile
        clock = profile(activities=[ProfilerActivity.CUDA])
        clock.__enter__()
    calls, kept, n_traced = [], [], 0
    collections = Collections().start()
    cpu0 = time.process_time()
    w0 = time.perf_counter()
    try:
        while time.perf_counter() - w0 < seconds:
            idx = draw()
            batch = [pool[i] for i in idx]
            t0, c0 = time.perf_counter(), time.process_time()
            r0 = resource.getrusage(resource.RUSAGE_SELF)
            res, stats, errors = call.run(batch, device, spans)
            t1 = time.perf_counter()
            r1 = resource.getrusage(resource.RUSAGE_SELF)
            rec = {"t0": t0 - w0, "wall_s": t1 - t0, "idx": idx,
                   "cpu_s": time.process_time() - c0,
                   "rusage": {k: getattr(r1, k) - getattr(r0, k)
                              for k in RUSAGE},
                   "stats": stats, "spans_ms": dict(spans.ms),
                   "failed": sum(e is not None for e in errors),
                   "audio_s": float(corpus.seconds[idx].sum())}
            calls.append(rec)
            # reservoir sample of the calls whose output is compared
            n = len(calls)
            if len(kept) < KEEP_CALLS:
                kept.append((rec, res))
            elif rng_keep.random() < KEEP_CALLS / n:
                kept[int(rng_keep.integers(KEEP_CALLS))] = (rec, res)
            del res
            if spans.tracing and t1 - w0 >= TRACE_SECONDS:
                prof.__exit__(None, None, None)
                spans.tracing, n_traced = False, n
    finally:
        w1 = time.perf_counter()
        cpu1 = time.process_time()
        collections.stop()
        if spans.tracing:
            prof.__exit__(None, None, None)
            spans.tracing, n_traced = False, len(calls)
        dev_clock = None
        if clock is not None:
            t_read = time.perf_counter()
            clock.__exit__(None, None, None)
            dev_clock = trace_mod.device_time(clock)
            dev_clock["read_s"] = time.perf_counter() - t_read
            del clock
    summary = None
    if tracing:
        summary = trace_mod.summarise(trace_mod.reduce(prof, call.SPANS))
        summary["audio_s"] = sum(c["audio_s"] for c in calls[:n_traced])
        summary["work"] = _work(corpus, calls[:n_traced])

    mem_peak = None
    if device.startswith("cuda"):
        import torch
        mem_peak = int(torch.cuda.max_memory_allocated())
    run = {"calls": calls, "window_s": w1 - w0, "cpu_s": cpu1 - cpu0,
           "audio_s": sum(c["audio_s"] for c in calls), "setup_s": setup_s,
           "gc_s": collections.s, "gc_full": collections.full,
           "trace": summary, "work": _work(corpus, calls),
           "device_clock": dev_clock}
    values = {}
    for m in metrics:
        v = load_metric(m["name"]).value(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    checks, ctrl = compare(corpus, ref, call, cfg, kept, rng_keep, calls,
                           control)
    out = {"metrics": values, "checks": checks, "mem_peak": mem_peak,
           "control": ctrl,
           "attempted": B * len(calls),
           "failed": sum(c["failed"] for c in calls), "run": run}
    if summary:
        out["breakdown"] = trace_mod.breakdown(summary)
    return out


def _work(corpus, calls):
    """The generator's work counts summed over the streams of `calls`."""
    return {k: float(sum(v[c["idx"]].sum() for c in calls))
            for k, v in corpus.work.items()}


def compare(corpus, ref, call, cfg, kept, rng, calls, control=False):
    """Download the kept calls' output and hold a seeded sample of their
    lanes, the longest stream among them included, to the reference.
    Returns each number compared, with its limit, and the control's
    reading of the same lanes (None unless asked for)."""
    lanes = [(k, j, int(rec["idx"][j])) for k, (rec, _) in enumerate(kept)
             for j in range(len(rec["idx"]))]
    n_cmp = min(len(lanes), int(cfg["check"]["lanes"]))
    pick = [lanes[i] for i in rng.permutation(len(lanes))[:n_cmp]]
    if lanes:
        longest = max(lanes, key=lambda lane: corpus.seconds[lane[2]])
        if longest not in pick:
            pick[-1:] = [longest]
    outs = {k: call.outputs(kept[k][1]) for k in {k for k, _, _ in pick}}
    kept.clear()
    _free_device()
    worst, wrong, ctrl = 0.0, 0, 0.0
    for k, j, i in pick:
        got, want = outs[k][j], ref.expected(corpus, i)
        if got is None or got.shape != want.shape:
            wrong += 1
        else:
            worst = max(worst, ref.gap(corpus, got, want))
        if control:
            ctrl = max(ctrl, ref.gap(corpus, ref.control(corpus, i), want))
    checks = {"streams_failed": [sum(c["failed"] for c in calls), 0],
              "lanes_wrong_shape": [wrong, 0],
              "lanes_compared": [len(pick), 1],
              cfg["check"]["number"]: [worst, float(cfg["check"]["limit"])]}
    return checks, (ctrl if control else None)


def _free_device():
    """Give the card's cached blocks back once the program's state is
    gone (the reference runs on the host)."""
    if "torch" in sys.modules:
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def passed(checks: dict) -> bool:
    """Every number within its limit; at least one lane compared."""
    return all(v >= lim if name == "lanes_compared" else v <= lim
               for name, (v, lim) in checks.items())


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calls-out", default=None,
                    help="also write each call's start, wall and CPU time "
                    "(JSON lines) to this file inside the checkout")
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    cell, cfg, traffic, e2e, layer = cell_of(bench, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start,
                   metrics=layer if args.trace else e2e)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    if args.calls_out:
        with open(args.calls_out, "w") as f:
            for c in out["run"]["calls"]:
                f.write(json.dumps({k: c[k] for k in ("t0", "wall_s",
                                                      "cpu_s", "rusage")})
                        + "\n")
    dc = out["run"]["device_clock"]
    if dc:
        print(f"portbench: device clock {dc['n_ops']} operations, busy "
              f"{dc['busy_s']!r} s, read in {dc['read_s']:.2f} s",
              file=sys.stderr)
    checks = out["checks"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["mem_peak"]}
    if args.trace:
        tr = out["run"]["trace"] or {}
        device["busy_s"] = tr.get("busy_s", 0.0)
        device["window_s"] = tr.get("window_s", 0.0)
    result = {"correct": passed(checks) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if args.trace and "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
