"""Command line of ``scripts/codec_rate.py``: the rate and distortion of
the SIAM codec's wire format on a trained checkpoint, written into the run
directory as ``codec_rate.json`` with ``recon_wire_f16.wav`` (and, with
``--walk``, ``recon_wire_walk_f16.wav``).

    python -m mptpu_torch.scripts.codec_rate --run <dir> [--walk] [--device cuda]

The segment flags left at their defaults take the run's ``metrics.json``
config line. Event ``i`` decodes with ``mptpu``'s ``fold_in(PRNGKey(42), i)``
draw (``utils.jax_random``), the noise a ``--fixed-noise`` checkpoint was
trained with, as in the script.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models import codec_rate
from ..utils import jax_random
from .common import add_device, fail, watchdog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run", type=str,
                   default="trained_weights/siam_overfit_full_sw3")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--selection-leak", type=float, default=0.02)
    p.add_argument("--selection-floor", type=float, default=0.02)
    p.add_argument("--attn-floor", type=float, default=0.01)
    p.add_argument("--attn-leak", type=float, default=0.1)
    p.add_argument("--switch-clamp", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--n-samples-log2", type=int, default=17)
    p.add_argument("--n-events", type=int, default=32)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--context-dim", type=int, default=32)
    p.add_argument("--audio-events", type=int, default=0)
    p.add_argument("--stream-windows", type=int, default=1,
                   help="rebuild the trainer's longer segment; the rate "
                        "demo encodes its FIRST window")
    p.add_argument("--refine", type=int, default=256,
                   help="carry shift+gain corrections on the wire, "
                        "refined within this many samples (0 = off). "
                        "NOTE these corrections are the only part of "
                        "the r3 wire format with positive SNR (raw "
                        "wire decode was -0.147 dB); the JSON flags "
                        "refine_required accordingly")
    p.add_argument("--walk", action="store_true",
                   help="ALSO encode the FULL segment through the "
                        "default streaming walk (time-domain residual "
                        "handoff) and report whole-segment kbps vs "
                        "SNR/LSD/PIF with delta-coded event times — "
                        "the rate/distortion of the codec as deployed "
                        "(the first-window table covers only "
                        "covered_span_s of the segment)")
    p.add_argument("--watchdog-s", type=int, default=3000)
    return add_device(p)


def decoder_noise(run: str, flags: dict) -> torch.Tensor:
    """(n_events, 1, 1, noise size) of ``mptpu``'s draws, for the event
    count and segment length that ``flags`` and the run's config line give."""
    _, recorded = codec_rate.recorded_config(run)
    value = {k: (recorded.get(k, v) if v == codec_rate.DEFAULTS[k] else v)
             for k, v in flags.items()}
    return torch.from_numpy(jax_random.siam_event_noise(
        value["n_events"], min(8192, 2 ** value["n_samples_log2"])))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(args.watchdog_s)
    flags = {k: getattr(args, k) for k in codec_rate.DEFAULTS}
    try:
        codec_rate.rate_report(args.run, args.run, ckpt=args.ckpt, walk=args.walk,
                               noise=decoder_noise(args.run, flags), device=args.device,
                               **flags)
    except FileNotFoundError as e:
        return fail(f"{e} — the run dir may hold only whitelisted artifacts (wav/json)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
