#!/usr/bin/env python3
"""The readings a cell's limit is set from, on the card, in one process:
for each seed, a run of the cell at its own size (its corpus, batch and a
short window at its own load) and the number it compares, beside the
number the control reads on the same lanes (the reference computed one
precision lower, in the program's place).

    python3 portbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 3

The limit lies above the largest program reading and below the smallest
control reading (PERF.md gives both and the limit).  Prints one line a
seed and a JSON summary last.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first this many seeds "
                    "(default: all)")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    _, cfg, traffic, _, _ = harness.cell_of(
        harness.load_json("BENCHMARK.json"), args.workload)
    number = cfg["check"]["number"]
    rows = []
    n_ctrl = args.seeds if args.control_seeds is None else args.control_seeds
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        out = harness.run_cell(cfg, traffic, seed, args.seconds, False,
                               device="cuda", control=k < n_ctrl)
        row = {"seed": seed, "program": out["checks"][number][0],
               "control": out["control"],
               "correct": harness.passed(out["checks"])
               and out["failed"] == 0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "number": number,
                      "lower": max(r["program"] for r in rows),
                      "upper": min(r["control"] for r in rows
                                   if r["control"] is not None),
                      "all_correct": all(r["correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
