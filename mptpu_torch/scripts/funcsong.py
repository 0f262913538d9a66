"""Command line of ``scripts/funcsong.py``: fit a song as a function of
its position (``FuncSong``), writing ``recon_crop.wav`` and
``metrics.json`` into ``--out`` (``trained_weights/funcsong`` in the
working directory by default).

    python -m mptpu_torch.scripts.funcsong [--path song.wav]
        [--iterations 2000] [--smoke] [--out DIR] [--device cuda]

``--path`` is a WAV read by the port's own reader (mixed down to mono);
without it the song is ``--song-seconds`` of synthetic audio. ``--smoke``:
crops of 2^11 samples, 8 position channels, width 32, 2 layers, batch 2.
A traceback dump and exit at 7,200 s, as in the script.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models import funcsong
from .common import add_device, watchdog

WATCHDOG_S = 7200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--path", type=str, default=None,
                   help="wav file to fit; default = synthetic song")
    p.add_argument("--song-seconds", type=float, default=30.0)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--segment-samples", type=int, default=2**15)
    p.add_argument("--pos-channels", type=int, default=256)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="trained_weights/funcsong")
    p.add_argument("--smoke", action="store_true",
                   help="tiny config for CI: 2^11 samples, 8 pos channels")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    watchdog(WATCHDOG_S)
    os.makedirs(args.out, exist_ok=True)
    flags = {k: v for k, v in vars(args).items() if k != "device"}
    funcsong.train_funcsong(**flags, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
