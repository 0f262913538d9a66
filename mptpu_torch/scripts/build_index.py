"""Command line of ``scripts/build_index.py``: embed corpus chunks by
their multiband matching-pursuit events through a random projection,
store the index under ``trained_weights/search_index`` in the working
directory, and query it with a random chunk.

    python -m mptpu_torch.scripts.build_index [--chunks 32] [--chunk-size 16384]
        [--device cuda]

On the card each band's encode is a chain of 8 launches of the cluster
step kernel.
"""

from __future__ import annotations

import argparse
import sys

from ..models import search
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", type=int, default=32)
    parser.add_argument("--chunk-size", type=int, default=16384)
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--query", action="store_true", default=True)
    return add_device(parser)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    search.index_corpus(args.chunks, args.chunk_size, args.audio_path, args.query,
                        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
