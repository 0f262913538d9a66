"""Command line of ``scripts/overfit_stream_eval.py``: the streaming
walk's eval of a SIAM overfit checkpoint, written into the run directory
as ``stream_eval.json`` with ``recon_streaming.wav`` (and the refit and
pristine walks' WAVs when they run).

    python -m mptpu_torch.scripts.overfit_stream_eval --run <dir>
        [--gain-refit R] [--pristine-windows] [--device cuda]

Every window decodes event ``i`` with ``mptpu``'s ``fold_in(PRNGKey(42),
i)`` draw (``utils.jax_random``), the noise a ``--fixed-noise`` checkpoint
was trained with, as in the script.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import overfit_stream_eval
from ..utils import jax_random
from .common import add_device, fail, watchdog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run", type=str, default="trained_weights/siam_overfit4")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--selection-leak", type=float, default=0.02)
    p.add_argument("--selection-floor", type=float, default=0.0)
    p.add_argument("--attn-floor", type=float, default=0.01)
    p.add_argument("--attn-leak", type=float, default=0.1)
    p.add_argument("--switch-clamp", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--n-samples-log2", type=int, default=17)
    p.add_argument("--n-events", type=int, default=32)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--context-dim", type=int, default=32)
    p.add_argument("--audio-events", type=int, default=0,
                   help="match the trainer's synthetic density override")
    p.add_argument("--stream-windows", type=int, default=1,
                   help="match the trainer's --stream-windows: rebuild "
                        "the same longer segment and walk all of it")
    p.add_argument("--gain-refit", type=float, default=0.0,
                   help="also score the walk with OMP per-(window,event) "
                        "amplitude re-projection at this ridge "
                        "(models/siam.py refit_event_gains; 0 = skip)")
    p.add_argument("--align-refine", type=int, default=0,
                   help="with --gain-refit, additionally shift-align "
                        "every (window,event) track within this many "
                        "samples (refine_event_alignment; 0 = gains "
                        "only)")
    p.add_argument("--pristine-windows", action="store_true",
                   help="ALSO score the walk with every window encoded "
                        "from the original spectrogram instead of the "
                        "running residual (--stream-windows checkpoints "
                        "train each position on pristine input, so the "
                        "residual handoff is out-of-distribution)")
    p.add_argument("--watchdog-s", type=int, default=3600)
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    flags = {k: getattr(args, k) for k in overfit_stream_eval.DEFAULTS}
    try:
        noise = jax_random.siam_event_noise(args.n_events, min(8192, 2 ** args.n_samples_log2))
        overfit_stream_eval.stream_eval(args.run, args.run, ckpt=args.ckpt,
                                        noise=torch.from_numpy(noise), device=args.device,
                                        **flags)
    except FileNotFoundError as e:
        return fail(f"{e} — the run dir may hold only whitelisted artifacts (wav/json)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
