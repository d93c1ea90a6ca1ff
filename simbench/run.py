"""Benchmark of the PyTorch/CUDA LArTPC simulator (``repro_torch``) on one
cell of ``BENCHMARK.json``:

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's executor, warms it on one chunk, streams events through
the simulator's launcher for ``--seconds``, then checks a seeded sample of
the window's events against the plain reference. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ...; ``checks`` last); the numbers
compared, each with its limit, are the last lines of standard error.
Needs as many CUDA cards as the cell asks for, and exits 2 without them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def set_environment() -> None:
    """Import paths, and every cache of the program and of torch at a fixed
    place: inside the checkout, or under ``TMPDIR`` for the tuning cache
    (no cell resolves an ``auto`` strategy, so it stays empty)."""
    for path in (str(HERE), str(ROOT / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    cache = ROOT / ".simbench_cache"
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        (cache / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(cache / sub)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "simbench", "tune_cache.json")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    from lartpcbench import cells

    cell = cells.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"simbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lartpcbench import session

    result = session.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START)
    found = session.forbidden_modules(sys.modules)
    if found:
        print(f"simbench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
