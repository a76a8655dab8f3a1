"""entry.probe_ms: the mean wall, per call, of the benchmark's span around
BatchDecoder's constructor, which probes every stream (models.probe_all:
the format cascade and each decoder's index of its stream)."""

import numpy as np


def value(run):
    ms = [c["spans_ms"]["construct"] for c in run["calls"]
          if "construct" in c["spans_ms"]]
    return float(np.mean(ms)) if ms else None
