"""A cell cut to a size the CPU tests can run: a few short streams, small
banks, batches of at most 4, a few lanes compared.  The cells of
BENCHMARK.json, and the FLAC cell whose files wait for a later PR (PERF.md,
Open questions), built from the same kind of files."""

from portbench import harness

ROOT_DIR = harness.ROOT
#: cells not in BENCHMARK.json: (configuration file, traffic file)
LATER = {"librispeech_flac.b64": ("librispeech_flac", "utterances_b64")}


def tiny_cell(workload: str):
    """(cfg, traffic, e2e metrics, per-layer metrics) of `workload`, small."""
    bench = harness.load_json("BENCHMARK.json")
    if workload in {w["name"] for w in bench["workloads"]}:
        _, cfg, traffic, e2e, layer = harness.cell_of(bench, workload)
    else:
        conf, mix = LATER[workload]
        cfg = harness.load_json(f"portbench/configs/{conf}.json")
        traffic = harness.load_json(f"portbench/traffic/{mix}.json")
        e2e = [m for m in bench["end_to_end"] if "workloads" not in m]
        layer = []
    if cfg["format"] == "flac":
        cfg.update(distinct_utterances=10, bank_variants=2)
        traffic["lengths"].update(median_s=1.2, min_s=0.3, max_s=2.5)
    else:
        cfg.update(distinct_clips=8, bank_frames=48)
        traffic["lengths"]["seconds"] = 1.2   # two windows
    cfg["check"]["lanes"] = 6
    traffic["batch"] = min(int(traffic["batch"]), 4)
    return cfg, traffic, e2e, layer


def run_tiny(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.5,
             tracing: bool = False):
    """One run of the small cell on the CPU."""
    cfg, traffic, e2e, layer = tiny_cell(workload)
    return harness.run_cell(cfg, traffic, seed, seconds, tracing,
                            device="cpu", metrics=layer if tracing else e2e)
