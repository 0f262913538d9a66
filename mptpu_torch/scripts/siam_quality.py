"""Command line of ``scripts/siam_quality.py``: train the SIAM flagship's
reference configuration and report its step time (synced and pipelined)
and the reconstruction of held-out segments, writing ``metrics.json`` and
checkpoints into ``--out`` (``trained_weights/siam_quality`` in the working
directory by default).

    python -m mptpu_torch.scripts.siam_quality [--tiny | --medium] [--dense]
        [--iterations 2000] [--out DIR] [--device cuda]

``--watchdog-s`` bounds the run twice, as in the script: a traceback dump
and exit at that many seconds until the first step is logged, and the
run's own time budget; from then on each logged step (every 25th) re-arms
the dump at ``--stall-s``.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import sys

from ..models import siam_quality
from .common import add_device, watchdog


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--eval-every", type=int, default=250)
    parser.add_argument("--stream-eval-every", type=int, default=1000,
                        help="run the streaming-walk holdout eval (full-"
                             "segment coverage via the half-overlap window "
                             "walk) every N steps; 0 disables")
    parser.add_argument("--timing-steps", type=int, default=100)
    parser.add_argument("--attn-floor", type=float, default=0.0)
    parser.add_argument("--switch-clamp", type=float, default=100.0,
                        help="straight-through cap on the event-switch "
                             "amplitude (0 = exact reference; see the "
                             "round-3 NaN post-mortem in BENCHMARKS.md)")
    parser.add_argument("--residual-clamp", type=float, default=4.0,
                        help="clip the stop-gradient residual carry to "
                             "+/- this multiple of max|initial spec| "
                             "(0 = exact reference)")
    parser.add_argument("--encoder-clamp", type=float, default=1e4,
                        help="per-block activation clip in the gated "
                             "encoder stack (0 = exact reference)")
    parser.add_argument("--attn-leak", type=float, default=0.0,
                        help="straight-through leaky backward slope for the "
                             "attention relu (forward stays exact reference "
                             "relu); escapes the silence local optimum")
    parser.add_argument("--waveform-weight", type=float, default=0.0,
                        help="add W * relative waveform error on the first "
                             "half (the encoder-covered span) to the "
                             "spectral loss — the round-3 overfit campaign "
                             "showed the spectral loss alone never produces "
                             "positive waveform SNR (phase is unconstrained)")
    parser.add_argument("--selection-leak", type=float, default=0.0,
                        help="leaky-relu slope for decoder relu selections "
                             "(0 = exact reference)")
    parser.add_argument("--selection-floor", type=float, default=0.0,
                        help="additive floor on relu selection weights — the "
                             "round-3 fix for the greedy dead-event trap "
                             "(29/32 events permanently silent); 0 = exact "
                             "reference")
    parser.add_argument("--switch-bias-init", type=float, default=0.0,
                        help="initial bias of the event-switch head (positive "
                             "values start events audible instead of at the "
                             "silence saddle; 0 = exact reference)")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--fixed-noise", action="store_true",
                        help="pin ONE noise key for every forward (train "
                             "and eval) so the decoder's noise draws are "
                             "a fixed dictionary instead of a per-step "
                             "redraw. The reference redraws torch RNG "
                             "per forward, so its decode is stochastic "
                             "and the waveform term cannot converge EVEN "
                             "ON TRAINING DATA (proven by the r3 overfit "
                             "campaign: positive waveform SNR required "
                             "--fixed-noise). The r3 generalization run "
                             "trained stochastic and its holdout "
                             "waveform SNR pinned at ~0 — this flag "
                             "tests the train-side-stochasticity "
                             "hypothesis against the training-amount "
                             "one (VERDICT r3 missing #1)")
    parser.add_argument("--gain-refit", type=float, default=0.0,
                        help="train the waveform term THROUGH a per-event "
                             "OMP gain re-fit on the covered first half "
                             "(ridge value; 0 = off = r3 behavior). The "
                             "overfit campaign's decisive lever: raw-"
                             "trained amplitudes made waveform SNR a "
                             "scale problem (2.7 dB in 9k steps); "
                             "training through the refit made it "
                             "direction-only (9.4 dB in 1.8k). The r3/r4 "
                             "generalization runs trained raw — this "
                             "tests the same lever on holdout waveform "
                             "SNR (ROADMAP r4)")
    parser.add_argument("--gain-reg", type=float, default=0.0,
                        help="with --gain-refit: penalize (gain - 1)^2 on "
                             "alive events so the trained amplitudes "
                             "converge to the refit solution and the raw "
                             "decode stops relying on it")
    parser.add_argument("--b2", type=float, default=0.999,
                        help="Adam beta2; 0.95 adapts the second moment "
                             "within ~20 steps — the optimizer-cliff "
                             "guard from the overfit campaign "
                             "(nan_hunt4: finite grads, gnorm 3e13)")
    parser.add_argument("--trust-ratio", type=float, default=0.0,
                        help="per-leaf update clip: ||update|| <= ratio "
                             "* ||param|| (0 = off)")
    parser.add_argument("--out", type=str, default="trained_weights/siam_quality")
    parser.add_argument("--watchdog-s", type=int, default=14000)
    parser.add_argument("--stall-s", type=int, default=900,
                        help="re-armed per-progress watchdog: if no step "
                             "completes for this long (device wedge), dump "
                             "tracebacks and exit instead of hanging")
    parser.add_argument("--medium", action="store_true",
                        help="2^15/16-event scale (the r3 overfit "
                             "campaign's capacity-matched config) — "
                             "cheap enough per step to run a reference-"
                             "analogous number of steps on one chip")
    parser.add_argument("--tiny", action="store_true",
                        help="small config for smoke testing the script flow")
    parser.add_argument("--resume", action="store_true",
                        help="resume params/opt_state/step from the newest "
                             "checkpoint in --out (skips the timing phases)")
    parser.add_argument("--dense", action="store_true",
                        help="train on the MusicNet-density synthetic corpus")
    parser.add_argument("--fresh-corpus", action="store_true",
                        help="stream FRESHLY synthesized dense segments "
                             "every batch (infinite corpus, never-repeating "
                             "seeds disjoint from the holdout) instead of "
                             "cycling the fixed 144 s --dense corpus. The "
                             "30k-step round-4 run showed the fixed corpus "
                             "is memorized by ~5k steps (BENCHMARKS.md); "
                             "this removes that ceiling. Implies --dense "
                             "eval corpora (holdout stays the disjoint-"
                             "content fixed set so trajectories compare).")
    parser.add_argument("--spectral-skip", action="store_true",
                        help="SIAMModel.spectral_skip: condition the "
                             "event generator directly on the residual "
                             "spectrum at the selected frame (round-5 "
                             "generalization A/B; see anatomy.json "
                             "evidence in the model docstring)")
    parser.add_argument("--spectral-filter", action="store_true",
                        help="SIAMModel.spectral_filter: analysis-driven "
                             "zero-phase source-filter stage (round-5 arm C; "
                             "see model docstring)")
    parser.add_argument("--no-fade", action="store_true",
                        help="disable the reference's second-half target fade")
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    os.makedirs(args.out, exist_ok=True)

    def log(line: str) -> None:
        if line.startswith("iter "):
            # progress: re-arm the stall watchdog
            faulthandler.cancel_dump_traceback_later()
            watchdog(args.stall_s)
        print(line, flush=True)

    flags = {k: v for k, v in vars(args).items() if k not in ("out", "stall_s", "device")}
    siam_quality.run_siam_quality(args.out, **flags, device=args.device, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
