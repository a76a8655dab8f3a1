"""call_p95_ms: the 95th percentile of the walls of all the window's
calls, each from the decoder's constructor to its output on the card (a
training step waits for its batch)."""

import numpy as np


def value(run):
    walls = [c["wall_s"] for c in run["calls"]]
    return float(np.percentile(walls, 95) * 1e3) if walls else None
