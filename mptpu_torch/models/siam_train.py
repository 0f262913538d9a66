"""The flagship SIAM trainer (counterpart of ``scripts/train_siam.py:
train_and_monitor``): stream audio batches, run the 32-step encode /
generate loop, optimise the greedy energy-removal loss with Adam (b1 0.9,
b2 0.999, lr 1e-4), keep the event-vector reservoir for self-supervised
previews, log to the dashboard and checkpoint.

The step is ``parallel.make_data_parallel_step``: with ``data_parallel``
on the process group's ``data`` mesh (the ranks' gradients summed), else
in one process. Both take the update only where the loss and the gradient
norm are finite, on the device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..data.audioiter import AudioIterator
from ..device import default_device
from ..losses.iterative import iterative_loss
from ..obs.collection import Collection
from ..obs.server import serve_collection
from ..parallel.dp import make_data_parallel_step
from ..parallel.mesh import make_mesh
from ..sparse import quantize
from ..train.checkpoint import CheckpointManager
from ..train.optim import Adam, adam_state_from_tree, adam_state_tree
from .siam import (Reservoir, SIAMModel, draw_noise, fade_tail, make_iterative_fn,
                   make_random_sequence_fn, siam_transform)
from .siam_overfit import siam_sizes


def siam_train_loss(model: SIAMModel, window: int, step: int):
    """``loss(target, noise) -> (loss, (channels, vecs))``: the script's
    loss, the iterative loss of the faded target against the channels of
    the decomposition of the unfaded one (``mptpu`` alike), summed over the
    batch."""
    iterative = make_iterative_fn(model)
    fade = None

    def loss(target: torch.Tensor, noise: torch.Tensor):
        nonlocal fade
        if fade is None:
            fade = fade_tail(model.n_samples, device=target.device).to(target.dtype)
        channels, vecs, _, _ = iterative(target, noise)
        value = iterative_loss(target * fade, channels,
                               lambda x: siam_transform(x, window, step, mag_epsilon=1e-6))
        return value, (channels, vecs)

    return loss


@dataclass
class SIAMTrainResult:
    """The trained model, the losses logged every ``log_every`` steps, the
    reservoir, the collection (None without a dashboard), and the host
    clock at the start of each step (the last entry at the loop's end)."""

    model: SIAMModel
    losses: List[float]
    reservoir: Reservoir
    collection: Optional[Collection]
    step_starts: List[float] = field(default_factory=list)


def train_and_monitor(
    batch_size: int = 2, overfit: bool = False, port: int = 9999, save_weights: bool = False,
    load_weights: bool = False, iterations: Optional[int] = None, tiny: bool = False,
    audio_path: Optional[str] = None, data_parallel: bool = False, attn_floor: float = 0.0,
    attn_leak: float = 0.0, switch_clamp: float = 100.0, residual_clamp: float = 4.0,
    encoder_clamp: float = 1e4, log_every: int = 10, seed: Optional[int] = None,
    selection_leak: float = 0.0, device=None,
    dashboard: Optional[str] = os.path.join("trained_weights", "siam_dashboard"),
    checkpoint_dir: str = os.path.join("trained_weights", "siam"),
    log: Callable[[str], None] = print,
) -> SIAMTrainResult:
    """The script's ``train_and_monitor``; its arguments are the script's,
    and ``port=0`` starts no dashboard server. The port's own: the
    parameters from a generator seeded 0, each step's decoder noise (one
    draw per item) and the previews' draws from a generator seeded 0
    (``mptpu`` folds the step into a key), the
    dashboard's and the checkpoints' directories (the script's, relative
    to the working directory, by default; ``dashboard=None`` logs to no
    dashboard, as a data-parallel rank other than 0). ``data_parallel`` needs a
    ``torch.distributed`` process group: the batch is cut over its ranks
    and their gradients summed; every rank must pass the same batches
    (the same ``seed``)."""
    dev = default_device(device)
    knob = quantize.RELU_SELECTION_LEAK
    if selection_leak:
        quantize.set_selection_leak(selection_leak)
    try:
        return _train(locals(), dev)
    finally:
        quantize.set_selection_leak(knob)


def _train(a: dict, dev: torch.device) -> SIAMTrainResult:
    sz = siam_sizes(a["tiny"])
    n_samples, n_events, window, step_sz = (sz[k] for k in ("n_samples", "n_events", "window",
                                                            "step"))
    log = a["log"]
    model = SIAMModel(
        n_samples=n_samples, context_dim=sz["context_dim"], in_channels=window // 2 + 1,
        hidden_channels=sz["hidden"], n_events=n_events, transform_window_size=window,
        transform_step_size=step_sz, fft_resonance=True, attn_floor=a["attn_floor"],
        attn_leak=a["attn_leak"], switch_clamp=a["switch_clamp"],
        residual_clamp_scale=a["residual_clamp"], encoder_clamp=a["encoder_clamp"],
        generator=torch.Generator().manual_seed(0), device=dev)
    stream = AudioIterator(batch_size=a["batch_size"], n_samples=n_samples, samplerate=22050,
                           normalize=True, overfit=a["overfit"], audio_path=a["audio_path"],
                           seed=a["seed"], device=dev)
    collection = Collection(a["dashboard"]) if a["dashboard"] else None
    server = serve_collection(collection, port=a["port"]) if a["port"] and collection else None

    opt = Adam(lr=1e-4, b1=0.9, b2=0.999)
    params = list(model.parameters())
    opt_state = opt.init(params)
    ckpt = CheckpointManager(a["checkpoint_dir"], every=100)
    reservoir = Reservoir(256, sz["context_dim"])
    random_seq = make_random_sequence_fn(model)
    names = [n for n, _ in model.named_parameters()]

    start_iter = 0
    if a["load_weights"]:
        payload = ckpt.latest()
        if payload is not None:
            convert.siam_from_flax(model, payload["params"])
            if payload["opt_state"] is not None:
                opt_state = adam_state_from_tree(payload["opt_state"], names, dev)
            start_iter = payload["step"]
            log(f"resumed from step {start_iter}")

    mesh = None
    if a["data_parallel"]:
        if not dist.is_initialized():
            raise RuntimeError("data_parallel needs a torch.distributed process group; call "
                               "init_process_group in every rank first")
        # every rank built the same parameters from seed 0 (or loaded
        # the same checkpoint), as mptpu's replicated sharding holds them
        mesh = make_mesh(axis_names=("data",), device=dev)
    loss_fn = siam_train_loss(model, window, step_sz)
    aux = {}

    def summed(target, noise):
        value, aux["out"] = loss_fn(target, noise)
        return value

    # noise is (n_events, batch, 1, size): its batch axis is 1
    train_step = make_data_parallel_step(summed, opt, mesh, batch_dims=(0, 1))
    gen = torch.Generator(device=dev).manual_seed(0)

    losses: List[float] = []
    starts: List[float] = []
    try:
        for i, item in enumerate(iter(stream), start=start_iter):
            if a["iterations"] is not None and i >= a["iterations"]:
                break
            t0 = time.time()
            starts.append(time.perf_counter())
            noise = draw_noise(model, (n_events, item.shape[0]), gen)
            opt_state, loss = train_step(params, opt_state, item, noise)
            channels, vecs = aux.pop("out")
            if i % a["log_every"] == 0:
                loss = float(loss)
                losses.append(loss)
                log(f"iter {i} loss {loss:.4f} ({time.time() - t0:.2f}s)")
                reservoir.update(vecs.detach().cpu().numpy())
                if collection is not None:
                    collection.log("orig", item[0, 0], kind="audio")
                    collection.log("recon", torch.sum(channels.detach(), dim=1)[0], kind="audio")
                    collection.log("loss", np.asarray(losses[-200:]))
            if i % 100 == 0 and i > 0:
                rvecs = torch.from_numpy(reservoir.sample(1, n_events)).to(dev)
                rand_audio, _, _ = random_seq(rvecs, generator=gen)
                if collection is not None:
                    collection.log("random", torch.sum(rand_audio, dim=1)[0], kind="audio")
            if a["save_weights"] and i % ckpt.every == 0:
                ckpt.maybe_save(i, convert.module_to_flax(model), adam_state_tree(opt_state, names))
        starts.append(time.perf_counter())
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    return SIAMTrainResult(model, losses, reservoir, collection, starts)
