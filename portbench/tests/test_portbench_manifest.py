"""BENCHMARK.json against the contract it is written to, and every metric
file against runs recorded on the card (a profiler trace reduced by
portbench/trace.py, the calls' BatchDecoder.stats, the work counts)."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DATA = os.path.join(os.path.dirname(__file__), "data")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def _recorded(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        cfg = harness.load_json(c["file"])
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            harness.HERE, "traffic", w["traffic"] + ".json"))
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]:
        assert "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_run_length():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_each_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert cell in E2E[m["moves"]].get("workloads", [cell])
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_metric_files_read_a_recorded_run(cell):
    """Each metric of the cell reads a number from the run recorded on the
    card in a cell of the same configuration; a roofline share lies in
    (0, 100]."""
    fmt = harness.load_json({c["name"]: c for c in BENCH["configs"]}
                            [CELLS[cell]["config"]]["file"])["format"]
    run = _recorded(f"recorded_{fmt}.json")
    run_e2e = _recorded(f"recorded_{fmt}_e2e.json")
    for m in _metrics():
        if cell not in m.get("workloads", [cell]):
            continue
        # an end-to-end metric is read from an untraced run, a per-layer
        # metric from a traced one
        got = run_e2e if m in BENCH["end_to_end"] else run
        v = harness.load_metric(m["name"]).value(got)
        assert v is not None and v > 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100.0, m["name"]
    rtf = harness.load_metric("call.audio_rtf").value(run)
    assert rtf == pytest.approx(run["audio_s"] / run["window_s"])


def test_every_metric_file_reads_a_recorded_run():
    """Every reader under metrics/, those of the cells kept for a later PR
    too, reads a number above 0 from a run recorded on the card."""
    runs = [_recorded(name) for name in sorted(os.listdir(DATA))]
    for name in sorted(os.listdir(os.path.join(harness.HERE, "metrics"))):
        mod = harness.load_metric(name[:-3])
        got = [mod.value(run) for run in runs]
        assert any(v is not None and v > 0 for v in got), name


def test_traffic_with_keys_the_harness_does_not_read_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    cell = bench["workloads"][0]
    traffic = harness.load_json(os.path.join(
        "portbench", "traffic", cell["traffic"] + ".json"))
    traffic["clients"] = 4
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "x.json").write_text(json.dumps(traffic))
    cell["traffic"] = os.path.relpath(tmp_path / "traffic" / "x",
                                      os.path.join(harness.HERE, "traffic"))
    with pytest.raises(SystemExit):
        harness.cell_of(bench, cell["name"])


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = {"calls": [], "window_s": 1.0, "cpu_s": 0.0, "audio_s": 0.0,
             "setup_s": 1.0, "trace": None, "work": {},
             "device_clock": None}
    for m in _metrics():
        if m["name"] != "setup_s":
            assert harness.load_metric(m["name"]).value(empty) is None


def test_device_clock_takes_the_union_of_operations():
    """The whole window's device time counts overlapping operations once."""
    from torch.autograd import DeviceType

    from portbench import trace

    class Event:
        def __init__(self, a, b, kind=DeviceType.CUDA):
            self.a, self.b, self.kind = a, b, kind

        def start_ns(self):
            return self.a

        def duration_ns(self):
            return self.b - self.a

        def device_type(self):
            return self.kind

    events = [Event(0, 10), Event(5, 20), Event(30, 40), Event(35, 38),
              Event(50, 60), Event(0, 100, DeviceType.CPU)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    got = trace.device_time(Prof)
    assert got["n_ops"] == 5
    assert got["busy_s"] == pytest.approx(40e-9)
    assert got["op_s"] == pytest.approx(48e-9)
