"""The readings the comparison's limits are set from, in one process:

    python3 simbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--control]

For each seed: a short window of the cell at its own load, then the
comparison of its sampled events, printed as one JSON line
(``{"seed", "events", "numbers"}``). Without ``--control`` the program is
measured (the lower readings); with it the plain reference computing in
bfloat16 stands in the program's place (the control, which has to come
out as not correct). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import set_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one window each")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    set_environment()
    import torch

    from lartpcbench import cells, check, control, session

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    sess = session.Session(
        cell, "cuda",
        executor=control.reference_executor if args.control else None)
    sess.warm(seeds[0])
    for seed in seeds:
        t0 = time.perf_counter()
        stats, res = sess.measure(seed, args.seconds)
        numbers = sess.compare(res.items)
        print(json.dumps({
            "seed": seed, "control": args.control, "events": stats.events,
            "window_s": stats.window_s,
            "check_s": time.perf_counter() - t0 - stats.window_s,
            "numbers": numbers,
            "correct": check.verdict(numbers, cell.limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
