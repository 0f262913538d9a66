"""Command line of ``scripts/overfit_refine_eval.py``: score a SIAM
overfit checkpoint's first-half eval raw, with the joint gain re-fit and
with the shift and gain alignment refinement, writing
``refine_eval.json`` and ``recon_aligned_best.wav`` into the run
directory.

    python -m mptpu_torch.scripts.overfit_refine_eval --run <dir>
        [--ckpt FILE] [--align-refine 256] [--device cuda]

The model is at sw6's widths, as the script hard-codes them; the
checkpoint is ``--ckpt``, else the run's newest ``ckpt_*.pkl`` (a run
without one exits 1, as the script). Event ``i`` decodes with ``mptpu``'s
``fold_in(PRNGKey(--noise-seed), i)`` draw (``utils.jax_random``), the
noise a ``--fixed-noise`` checkpoint was trained with.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import overfit_refine_eval
from ..utils import jax_random
from .common import add_device, fail, watchdog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run", type=str, default="trained_weights/siam_overfit5")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--attn-floor", type=float, default=0.01)
    p.add_argument("--attn-leak", type=float, default=0.1)
    p.add_argument("--selection-leak", type=float, default=0.02)
    p.add_argument("--selection-floor", type=float, default=0.02)
    p.add_argument("--switch-clamp", type=float, default=20.0)
    p.add_argument("--noise-seed", type=int, default=42,
                   help="the trainer's --fixed-noise key")
    p.add_argument("--gain-refit", type=float, default=1e-3)
    p.add_argument("--align-refine", type=int, default=256)
    p.add_argument("--align-iters", type=int, default=3)
    p.add_argument("--watchdog-s", type=int, default=5400)
    return add_device(p)


def eval_noise(seed: int) -> torch.Tensor:
    """``mptpu``'s draws (n_events, 1, 1, noise size) from ``seed`` for the
    model the evaluations build (``overfit_refine_eval.WIDTHS``)."""
    w = overfit_refine_eval.WIDTHS
    return torch.from_numpy(jax_random.siam_event_noise(w["n_events"], min(8192, w["n_samples"]),
                                                        seed=seed))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    flags = {k: getattr(args, k) for k in overfit_refine_eval.DEFAULTS}
    try:
        overfit_refine_eval.refine_eval(args.run, args.run, ckpt=args.ckpt,
                                        noise=eval_noise(args.noise_seed), device=args.device,
                                        **flags)
    except FileNotFoundError as e:
        return fail(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
