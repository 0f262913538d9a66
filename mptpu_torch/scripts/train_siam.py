"""Command line of ``scripts/train_siam.py``, the flagship SIAM trainer:
stream audio batches, train the iterative decomposition, keep the event
reservoir, serve the dashboard on ``--port`` (0 serves none) and, with
``--save-weights``, checkpoint under ``trained_weights/siam`` in the
working directory.

    python -m mptpu_torch.scripts.train_siam [--tiny] [--iterations N]
        [--port 9999] [--save-weights] [--load-weights] [--device cuda]

Started as one process, ``--data-parallel`` trains on the whole batch, as
the script does on one device. Started as one rank of several by a
launcher that describes the group in the environment (``WORLD_SIZE`` above
1, or ``RANK`` set, as ``torchrun`` does) with ``--data-parallel``, it
joins that group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``), cuts each batch over the ranks and sums their gradients, as the
script shards the batch over the devices it sees:

    torchrun --standalone --nproc-per-node 4 -m mptpu_torch.scripts.train_siam \\
        --data-parallel [--seed S] [...]

Every rank streams the same batches (``--seed``, or a seed that rank 0
draws and sends to the others); rank 0 alone prints, serves the dashboard
and writes the dashboard and the checkpoints, the counterpart of the
script's one process. The group is left on every way out.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..data import datastore
from ..device import default_device
from ..models import siam_train
from .common import add_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--port", type=int, default=9999)
    parser.add_argument("--save-weights", action="store_true")
    parser.add_argument("--load-weights", action="store_true")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="small config for smoke testing")
    parser.add_argument("--audio-path", type=str, default=None)
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard the batch over all devices")
    parser.add_argument("--attn-floor", type=float, default=0.0,
                        help="amplitude floor keeping event gradients alive")
    parser.add_argument("--switch-clamp", type=float, default=100.0,
                        help="straight-through cap on the event-switch "
                             "amplitude (0 = exact reference semantics)")
    parser.add_argument("--residual-clamp", type=float, default=4.0,
                        help="residual-carry clip as a multiple of "
                             "max|initial spec| (0 = exact reference)")
    parser.add_argument("--encoder-clamp", type=float, default=1e4,
                        help="per-block activation clip in the gated "
                             "encoder stack (0 = exact reference)")
    parser.add_argument("--attn-leak", type=float, default=0.0,
                        help="straight-through leaky backward for the attention\n"
                             "relu (forward stays exact reference relu)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--selection-leak", type=float, default=0.0,
                        help="leaky-relu slope for relu item selections; keeps\n"
                             "gradients alive if every selection goes negative")
    parser.add_argument("--seed", type=int, default=None,
                        help="data seed; with --overfit pins the segment so a\n"
                             "report can be generated on the same audio")
    return add_device(parser)


def launched_as_rank() -> bool:
    """Whether a launcher started this process as one rank of a group."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 or "RANK" in os.environ


def join_group(device: str) -> torch.device:
    """Join the group the launcher's environment describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): NCCL on
    ``cuda:LOCAL_RANK``, or gloo on the CPU. Returns this rank's device."""
    dev = default_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return dev


def shared_seed(seed) -> int:
    """The data seed of every rank: ``seed``, or one that rank 0 draws."""
    box = [seed if seed is not None else int(np.random.SeedSequence().entropy % 2**63)]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def train(args, **kwargs) -> siam_train.SIAMTrainResult:
    """``train_and_monitor`` with the script's flags; ``kwargs`` override."""
    flags = dict(
        batch_size=args.batch_size,
        overfit=args.overfit,
        port=args.port,
        save_weights=args.save_weights,
        load_weights=args.load_weights,
        iterations=args.iterations,
        tiny=args.tiny,
        audio_path=args.audio_path,
        data_parallel=False,   # one process: the whole batch
        attn_floor=args.attn_floor,
        attn_leak=args.attn_leak,
        switch_clamp=args.switch_clamp,
        residual_clamp=args.residual_clamp,
        encoder_clamp=args.encoder_clamp,
        log_every=args.log_every,
        seed=args.seed,
        selection_leak=args.selection_leak,
        device=args.device,
    )
    return siam_train.train_and_monitor(**dict(flags, **kwargs))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.data_parallel and launched_as_rank()):
        train(args)
        return 0
    device = join_group(args.device)
    try:
        lead = dist.get_rank() == 0
        seed = shared_seed(args.seed)
        if lead:   # the demo corpus, when it is read, is written once, before any rank reads it
            datastore._resolve_path(args.audio_path)
        dist.barrier()
        quiet = {} if lead else dict(port=0, save_weights=False, dashboard=None,
                                     log=lambda line: None)
        train(args, data_parallel=True, seed=seed, device=device, **quiet)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
