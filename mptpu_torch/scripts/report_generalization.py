"""Command line of ``scripts/report_generalization.py``: the held-out
metric trajectories of several quality runs as one standalone HTML page
(``--out``, ``report_generalization.html`` in the working directory by
default).

    python -m mptpu_torch.scripts.report_generalization
        [--runs "run_dir:label,..."] [--out page.html] [--device cuda]

Each run is a directory under ``trained_weights`` in the working
directory, as in the script; one without ``metrics.json`` (or without
evals) is skipped with a line, and none left exits 1. The page is drawn
from the runs' files alone: ``--device`` is taken and nothing runs on it.
"""

from __future__ import annotations

import argparse
import sys

from ..models import report_generalization
from .common import add_device, fail


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--runs",
        type=str,
        default="siam_quality_medium:fixed 144s corpus,"
        "siam_quality_fresh:fresh infinite corpus",
        help="comma list of run_dir:label under trained_weights/",
    )
    p.add_argument("--out", type=str, default="report_generalization.html")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    runs = [spec.partition(":")[::2] for spec in args.runs.split(",")]
    try:
        report_generalization.make_generalization_report(runs, args.out, root="trained_weights")
    except ValueError as e:
        return fail(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
