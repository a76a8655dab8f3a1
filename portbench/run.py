#!/usr/bin/env python3
"""Run one cell of audio_formats_torch's benchmark once, on the CUDA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and each number compared with its limit as the last lines of standard
error.  Cells, configurations and metrics are named in BENCHMARK.json.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
