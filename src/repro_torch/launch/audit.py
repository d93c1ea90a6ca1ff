"""One-command static-analysis gate of the port: torch-lint + the audit.

    PYTHONPATH=src python -m repro_torch.launch.audit          # the gate
    PYTHONPATH=src python -m repro_torch.launch.audit --planes 1 --devices 2

Runs ``repro_torch.analysis.lint`` over ``src/repro_torch`` first (stdlib
only, cheap), then ``repro_torch.analysis.audit --check`` against the
committed ``AUDIT_torch_contracts.json``, on the CPU. Exits non-zero when
either fails. Audit options (``--planes/--devices/--baseline/--json/
--programs/--inject``) pass through; ``--update`` refreshes the baseline
instead of checking (the lint still runs).

The counterpart of the reference's ``repro.launch.audit``. Nothing here
imports torch at module scope: the lint needs none, and the audit starts
its distributed ranks only when it runs them.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

#: the port's sources, which the lint sweeps by default
PORT_SRC = os.path.join("src", "repro_torch")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.audit",
        description="torch-lint + program contract audit of the port "
                    "(docs/analysis_torch.md)")
    ap.add_argument("--lint-paths", nargs="+", default=[PORT_SRC],
                    help=f"paths torch-lint sweeps (default: {PORT_SRC})")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-audit", action="store_true")
    args, audit_args = ap.parse_known_args(argv)

    rc = 0
    if not args.skip_lint:
        from repro_torch.analysis import lint

        print(f"== torch-lint {' '.join(args.lint_paths)}", flush=True)
        rc = max(rc, lint.main(list(args.lint_paths)))
    if not args.skip_audit:
        from repro_torch.analysis import audit

        if not any(a in ("--check", "--update") for a in audit_args):
            audit_args = ["--check", *audit_args]
        print(f"== contract audit {' '.join(audit_args)}", flush=True)
        rc = max(rc, audit.main(audit_args))
    return rc


if __name__ == "__main__":
    sys.exit(main())
