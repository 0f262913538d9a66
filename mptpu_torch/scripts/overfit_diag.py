"""Command line of ``scripts/overfit_diag.py``: split a SIAM overfit
checkpoint's first-half error into phase, magnitude and coverage parts,
writing ``diag.json`` into the run directory.

    python -m mptpu_torch.scripts.overfit_diag --run <dir> [--ckpt FILE]
        [--device cuda]

The model is at sw6's widths, as the script hard-codes them; the
checkpoint is ``--ckpt``, else the run's newest ``ckpt_*.pkl`` (a run
without one exits 1, as the script). Event ``i`` decodes with ``mptpu``'s
``fold_in(PRNGKey(42), i)`` draw, the trainer's ``--fixed-noise``.
"""

from __future__ import annotations

import argparse
import sys

from ..models import overfit_diag
from .common import add_device, fail, watchdog
from .overfit_refine_eval import eval_noise


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run", type=str, default="trained_weights/siam_overfit4")
    p.add_argument("--ckpt", type=str, default=None,
                   help="explicit checkpoint path; default = newest in --run")
    p.add_argument("--selection-leak", type=float, default=0.02)
    p.add_argument("--selection-floor", type=float, default=0.0)
    p.add_argument("--attn-floor", type=float, default=0.01)
    p.add_argument("--attn-leak", type=float, default=0.1)
    p.add_argument("--switch-clamp", type=float, default=20.0)
    p.add_argument("--switch-bias-init", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--watchdog-s", type=int, default=3600)
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    flags = {k: getattr(args, k) for k in overfit_diag.DEFAULTS}
    try:
        overfit_diag.diag(args.run, args.run, ckpt=args.ckpt, noise=eval_noise(42),
                          device=args.device, **flags)
    except FileNotFoundError as e:
        return fail(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
