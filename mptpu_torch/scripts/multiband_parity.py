"""Command line of ``scripts/multiband_parity.py``: the multiband
dictionary-learning trajectory at ``e_2024_4_24``'s configuration (7
octave bands from 512 to 32,768 samples, 512 atoms x 128 taps, 2^15
samples), the reconstruction SNR after each of ``--iterations`` learning
iterations, one JSON line each, written with the configuration to
``trained_weights/multiband_parity.json`` under the working directory, as
the script does.

    python -m mptpu_torch.scripts.multiband_parity [--iterations 10]
        [--steps 64] [--batch-size 2] [--device cuda]

The script runs the reference implementation (the original PyTorch code)
beside its own on the CPU, from a directory outside the checkout. The
command line runs it where the environment variable ``MPTPU_REFERENCE``
names a directory that holds it, and otherwise writes the port's rows
alone, with a line that says so. On a card each band's encodes run the
cluster step kernel: 64 launches a band an encode at the default
``--steps``, 7 encodes a band for ``--iterations 3`` (3,136 in all).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..models import multiband_parity
from .common import add_device

REFERENCE_VARIABLE = "MPTPU_REFERENCE"
OUT = os.path.join("trained_weights", "multiband_parity.json")
# the script's keys of a row, in its order, and the digits it rounds each to
DIGITS = {"iteration": None, "ref_snr_db": 3, "ours_snr_db": 3, "delta_db": 3, "ref_learn_s": 1,
          "ours_learn_s": 1}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=2)
    return add_device(p)


def rounded(row: dict) -> dict:
    """``row`` with the script's keys in its order, rounded as it rounds."""
    return {k: (row[k] if d is None else round(row[k], d)) for k, d in DIGITS.items() if k in row}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    reference = os.environ.get(REFERENCE_VARIABLE)
    if not (reference and os.path.isdir(reference)):
        print(f"no reference implementation ({REFERENCE_VARIABLE} names no directory): the "
              "port's rows alone", flush=True)
        reference = None
    on_card = torch.device(args.device).type == "cuda"
    result = multiband_parity.parity_trajectory(
        args.iterations, device=args.device, reference=reference, log=lambda line: None,
        sync=torch.cuda.synchronize if on_card else lambda: None,
        on_row=lambda row: print(json.dumps(rounded(row)), flush=True),
        steps=args.steps, batch_size=args.batch_size)
    rows = [rounded(r) for r in result["rows"]]
    out = {"config": result["config"] + (", CPU both sides" if reference and not on_card
                                         else f", the port on {args.device}"),
           "rows": rows}
    if reference:
        out["max_abs_delta_db"] = max(abs(r["delta_db"]) for r in rows)
    out["wall_s"] = round(result["wall_s"], 1)
    os.makedirs("trained_weights", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    if reference:
        print(f"max |delta| {out['max_abs_delta_db']} dB ({out['wall_s']}s)", flush=True)
    else:
        print(f"ours {rows[-1]['ours_snr_db']} dB after {args.iterations} iterations "
              f"({out['wall_s']}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
