"""Room acoustics by blockwise transfer in the frequency domain on a voxel
grid, and the learnable 2-D room (counterpart of ``mptpu/gen/roomsim.py``
and of ``scripts/roomsim.py``'s simulation and overfit).

Each frame injects the control signal's energy into the room state
(block, W, H, D), applies every voxel's transfer to the state's spectrum
over the block, records the spatial sum, and moves energy to the
neighbours by a 3x3x3 mean behind reflecting walls. ``mptpu``'s
``lax.scan`` over the frames is a Python loop here.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from ..ops import kinks
from ..ops.fft import real_ends
from ..train.optim import Adam
from ..utils.wav import write_wav
from ..nn.init import uniform_range_init


def _neighbor_average(state: torch.Tensor) -> torch.Tensor:
    """The 3x3(x3) mean over the spatial axes of (block, W, H, D), walls
    reflecting; a spatial axis of size 1 is left alone."""
    spatial = state.shape[1:]
    window = [3 if s > 1 else 1 for s in spatial]
    pads = []
    for s in reversed(spatial):   # F.pad takes the last axis first
        pads += [1, 1] if s > 1 else [0, 0]
    padded = F.pad(state[:, None], pads, mode="reflect")
    return F.avg_pool3d(padded, window, stride=1)[:, 0]


def roomsim(transfer: torch.Tensor, control_signal: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the simulation: ``transfer`` (n_coeffs, W, H, D) gains,
    ``control_signal`` (n_frames, block, W, H, D) injections. Returns the
    recording (n_frames * block,) and the display frames (n_frames, W, H),
    each voxel's block norm at the middle depth."""
    n_frames, blocksize = control_signal.shape[:2]
    mid_depth = control_signal.shape[-1] // 2
    gains = transfer.movedim(0, -1)   # the FFT runs over the last axis
    state = torch.zeros_like(control_signal[0])
    recorded, frames = [], []
    for f in range(n_frames):
        state = state + control_signal[f]
        frames.append(torch.linalg.vector_norm(state[:, :, :, mid_depth], dim=0))
        spec = torch.fft.rfft(state.movedim(0, -1), dim=-1, norm="ortho")
        state = torch.fft.irfft(real_ends(gains * spec), n=blocksize, dim=-1,
                                norm="ortho").movedim(-1, 0)
        recorded.append(torch.sum(state, dim=(1, 2, 3)))
        state = _neighbor_average(state)
    return torch.stack(recorded).reshape(-1), torch.stack(frames)


class RoomModel(nn.Module):
    """The learnable 2-D room: per-voxel transfer gains ``responses``
    (n_coeffs, R, R), drawn in [1e-12, 0.9) and clipped to [0, 1], and a
    learned performance of injections ``performance`` (n_frames, voxel,
    R, R) in [-0.01, 0.01), rendered by :func:`roomsim` on a room one
    voxel deep. ``forward()`` gives the recording (1, 1, n_frames *
    voxel)."""

    def __init__(self, room_size: int, voxel_size: int, n_frames: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dev = default_device(device)
        n_coeffs = voxel_size // 2 + 1
        self.responses = nn.Parameter(uniform_range_init(
            (n_coeffs, room_size, room_size), 1e-12, 0.9, gen).to(dev))
        self.performance = nn.Parameter(uniform_range_init(
            (n_frames, voxel_size, room_size, room_size), -0.01, 0.01, gen).to(dev))

    def forward(self) -> torch.Tensor:
        transfer = kinks.clip(self.responses, 0.0, 1.0)[..., None]
        recording, _ = roomsim(transfer, self.performance[..., None])
        return recording.reshape(1, 1, -1)


class RoomSimulation(NamedTuple):
    transfer: np.ndarray       # (n_coeffs, W, H, D)
    control: np.ndarray        # (n_frames, block, W, H, D)
    recording: torch.Tensor    # (n_frames * block,)
    frames: torch.Tensor       # (n_frames, W, H)
    seconds: float             # the simulation's host time, ending in a synchronisation


def room_inputs(block_size: int = 64, n_frames: int = 512, width: int = 5, height: int = 17,
                depth: int = 9, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``scripts/roomsim.py``'s room, drawn by ``np.random.default_rng(seed)``:
    transfer gains in [0.99, 0.9999) falling off as ``sqrt(1 - f)`` over the
    coefficients, the first coefficient 0, and an impulse of uniform noise
    into voxel (3, 3, 3) in the first frame."""
    n_coeffs = block_size // 2 + 1
    rng = np.random.default_rng(seed)
    transfer = rng.uniform(0.99, 0.9999, (n_coeffs, width, height, depth)) \
        * np.linspace(1, 0, n_coeffs)[:, None, None, None] ** 0.5
    transfer[0] = 0.0
    control = np.zeros((n_frames, block_size, width, height, depth), dtype=np.float32)
    control[0, :, 3, 3, 3] = rng.uniform(-1, 1, block_size)
    return transfer, control


def simulate_room(block_size: int = 64, n_frames: int = 512, width: int = 5, height: int = 17,
                  depth: int = 9, samplerate: int = 22050, seed: int = 0, out: str | None = None,
                  device=None, log: Callable[[str], None] = print) -> RoomSimulation:
    """``scripts/roomsim.py``'s simulation on ``default_device(device)``:
    the room of :func:`room_inputs` (the gains cast to float32), simulated
    once; with ``out``, ``recording.wav`` (peak-normed) and ``frames.npy``
    written there."""
    dev = default_device(device)
    wavelength_ft = 1125.33 / (samplerate / block_size)
    log(f"room is {wavelength_ft * width:.1f} x {wavelength_ft * height:.1f} x "
        f"{wavelength_ft * depth:.1f} ft")
    transfer, control = room_inputs(block_size, n_frames, width, height, depth, seed)
    t_in = torch.from_numpy(transfer.astype(np.float32)).to(dev)
    c_in = torch.from_numpy(control).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        recording, frames = roomsim(t_in, c_in)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    log(f"simulated {recording.shape[0] / samplerate:.2f}s of audio in {seconds:.2f}s")
    if out:
        os.makedirs(out, exist_ok=True)
        rec = recording.cpu().numpy()
        write_wav(os.path.join(out, "recording.wav"), rec / (np.abs(rec).max() + 1e-9),
                  samplerate)
        np.save(os.path.join(out, "frames.npy"), frames.cpu().numpy())
    return RoomSimulation(transfer, control, recording, frames, seconds)


def room_loss(model: RoomModel, target: torch.Tensor) -> torch.Tensor:
    """The overfit's loss: the mean squared error of the recording."""
    return torch.mean((model() - target) ** 2)


class RoomFit(NamedTuple):
    model: RoomModel
    losses: List[float]        # every step's loss, read once after the loop
    step_starts: List[float]   # host clock at each step's start
    t_end: float               # host clock after the loop (synchronised on a card)


def overfit_room(target: torch.Tensor, room_size: int = 5, voxel_size: int = 64,
                 n_frames: int = 512, steps: int = 100, lr: float = 1e-2, seed: int = 0,
                 device=None,
                 log: Callable[[str], None] = print) -> RoomFit:
    """``scripts/roomsim.py --overfit-steps``: fit a :class:`RoomModel`
    (seeded with ``seed``) to ``target`` (1, 1, n_frames * voxel_size), the
    simulated recording over its peak, by optax's Adam at ``lr`` on the
    mean squared error."""
    dev = default_device(device)
    model = RoomModel(room_size, voxel_size, n_frames,
                      torch.Generator().manual_seed(seed), device=dev)
    target = target.to(dev)
    params = list(model.parameters())
    adam = Adam(lr)
    state = adam.init(params)
    losses, starts = [], []
    for i in range(steps):
        starts.append(time.perf_counter())
        loss = room_loss(model, target)
        grads = torch.autograd.grad(loss, params)
        updates, state = adam.update(grads, state)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
        losses.append(loss.detach())
        if i % 25 == 0:
            log(f"overfit iter {i} mse {float(losses[-1]):.6f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    return RoomFit(model, torch.stack(losses).tolist() if losses else [], starts, t_end)
