"""Command line of ``scripts/roomsim.py``: inject an impulse into a room of
voxels with random transfer functions and record its response, writing
``recording.wav`` (peak-normed), ``frames.npy`` (the energy movie) and
``metrics.json`` into ``--out`` (``trained_weights/roomsim`` in the working
directory by default); with ``--overfit-steps``, also fit the learnable
2-D room to that recording.

    python -m mptpu_torch.scripts.roomsim [--n-frames 512]
        [--overfit-steps N] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from .common import add_device

# gen's ``roomsim`` attribute is the simulation function, not this module
room = importlib.import_module("mptpu_torch.gen.roomsim")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--n-frames", type=int, default=512)
    p.add_argument("--width", type=int, default=5)
    p.add_argument("--height", type=int, default=17)
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--samplerate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overfit-steps", type=int, default=0,
                   help="also fit RoomModel to the rendered recording")
    p.add_argument("--out", type=str, default="trained_weights/roomsim")
    return add_device(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    sim = room.simulate_room(args.block_size, args.n_frames, args.width, args.height, args.depth,
                             args.samplerate, args.seed, out=args.out, device=args.device)
    recording = sim.recording.cpu()
    metrics = {"sim_seconds": sim.seconds, "n_samples": int(recording.shape[0])}
    if args.overfit_steps:
        target = (recording / (recording.abs().max() + 1e-9)).reshape(1, 1, -1)
        fit = room.overfit_room(target, room_size=args.width, voxel_size=args.block_size,
                                n_frames=args.n_frames, steps=args.overfit_steps,
                                seed=args.seed, device=args.device)
        metrics["overfit_losses"] = [[i, fit.losses[i]] for i in range(0, len(fit.losses), 25)]
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
