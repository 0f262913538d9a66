"""Command line of ``scripts/holdout_anatomy.py``: the event-level anatomy
of a SIAM checkpoint's held-out reconstruction (each event's correlation
with the residual it was meant to remove, at lag 0, at its best lag and
against another segment, and the four first-half SNRs that bracket what
the events could deliver), written to ``--out`` (default
``<run>/anatomy.json``).

    python -m mptpu_torch.scripts.holdout_anatomy --run <dir> [--align 256]
        [--out FILE] [--device cuda]

The run's settings come from its ``metrics.json`` config line, the
checkpoint is its newest ``ckpt_*.pkl`` (none: exit 1, as the script).
The held-out corpus is the quality runs', written into
``trained_weights/dense_corpus_holdout`` under the working directory when
absent, as the script does. Event ``i`` decodes with ``mptpu``'s
``fold_in(PRNGKey(42), i)`` draw for a run trained with fixed noise, else
``fold_in(PRNGKey(7), i)``, the script's keys.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..models import holdout_anatomy
from ..utils import jax_random
from .common import add_device, fail

HOLDOUT_DIR = os.path.join("trained_weights", "dense_corpus_holdout")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="trained_weights/siam_quality_fresh")
    ap.add_argument("--align", type=int, default=256,
                    help="±lag budget of the align-refine decode level")
    ap.add_argument("--out", default=None,
                    help="output JSON (default <run>/anatomy.json)")
    return add_device(ap)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = args.out or os.path.join(args.run, "anatomy.json")
    try:
        cfg = holdout_anatomy.parse_run_config(args.run)
        noise = jax_random.siam_event_noise(cfg["n_events"], min(8192, cfg["n_samples"]),
                                            seed=42 if cfg["fixed_noise"] else 7)
        holdout_anatomy.anatomy(args.run, os.path.dirname(out) or ".", holdout_dir=HOLDOUT_DIR,
                                align=args.align, noise=torch.from_numpy(noise),
                                device=args.device, path=out)
    except FileNotFoundError as e:
        return fail(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
