"""What every generator shares: the corpus it hands the harness, and the
length laws of the traffic files."""

from __future__ import annotations

from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np


@dataclass
class Corpus:
    """A seeded pool of streams.

    streams: the encoded bytes, the only thing the program is handed.
    seconds: each stream's audio seconds.
    work: per-stream counts of what a kernel must do (arrays by name),
      counted from what the generator wrote, for the roofline readers.
    truth: what the format's reference needs to recompute each stream's
      PCM (the generator's own PCM or spectra, never the program's).
    """
    streams: list
    seconds: np.ndarray
    work: dict = field(default_factory=dict)
    truth: dict = field(default_factory=dict)


def lengths_s(law: dict, n: int) -> np.ndarray:
    """n stream lengths in seconds: the law's quantiles at (i + 0.5) / n,
    so that every seed draws the same set of lengths (the seed only orders
    them and fills them).  Laws: {"law": "fixed", "seconds": s} and
    {"law": "lognormal", "median_s", "sigma", "min_s", "max_s"}."""
    if law["law"] == "fixed":
        return np.full(n, float(law["seconds"]))
    if law["law"] == "lognormal":
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        x = float(law["median_s"]) * np.exp(float(law["sigma"]) * z)
        return np.clip(x, float(law["min_s"]), float(law["max_s"]))
    raise ValueError(f"unknown length law {law['law']!r}")

