"""Command line of ``scripts/experiment.py``: run the current dated
experiment, scaffold a new one (``--new``), or list them (``--list``).

    python -m mptpu_torch.scripts.experiment [--new | --list]
        [--iterations N] [--device cuda]

The experiments directory is ``experiments_torch`` under the working
directory. The script's is the checkout's ``experiments/``, whose
experiments import ``mptpu``; the port's have a directory of their own
name, scaffolded from the port's template (``models/experiment_template.py``),
so that the port never runs ``mptpu``'s experiments nor writes beside them,
wherever it is started.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models import experiment
from .common import add_device, fail

EXPERIMENTS_DIR = "experiments_torch"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--new", action="store_true")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--iterations", type=int, default=None)
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.new:
        print(f"scaffolded {experiment.new_experiment(EXPERIMENTS_DIR)}")
    elif args.list:
        print("\n".join(experiment.list_experiments(EXPERIMENTS_DIR)))
    elif not os.path.exists(os.path.join(EXPERIMENTS_DIR, "__init__.py")):
        return fail(f"no current experiment: {EXPERIMENTS_DIR}/__init__.py is absent "
                    "(--new scaffolds one)")
    else:
        experiment.run_current(EXPERIMENTS_DIR, args.iterations, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
