"""The playable state-space instrument, BASELINE #5 (counterpart of
``mptpu/models/ssm_overfit.py`` and of ``scripts/ssm_article.py``): a
learned sparse control plane drives a tanh RNN whose states are projected
to frames of audio, overfit to one segment. ``train_model_for_segment`` is
the script's entry point.

The recurrence is ``torch.nn.RNN(bias=False, nonlinearity="tanh")``, the
layer of the original reference: on a card it is cuDNN's, one call for all
frames where a Python loop would launch a few kernels a frame. Its
weights are ``mptpu``'s transposed: ``weight_ih_l0`` is ``w_ihᵀ`` and
``weight_hh_l0`` is ``w_hhᵀ``. cuDNN runs float32 RNNs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, so the forward runs under
``no_tf32`` and so must the backward (the trainer's step does).
"""

from __future__ import annotations

import base64
import json
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.audioiter import get_one_audio_segment
from ..device import default_device, no_tf32
from ..losses.multiband_spec import flattened_multiband_spectrogram
from ..nn.init import uniform, uniform_init
from ..obs.article import AudioComponent, ImageComponent, conjure_article
from ..ops import kinks
from ..ops.norms import max_norm
from ..sparse.topk import sparsify


class InstrumentModel(nn.Module):
    """(batch, control_plane_dim, frames) -> (audio (batch, 1, frames *
    window_size), the frame-boundary differences (batch, frames - 1)): the
    control through ``proj``, the RNN, and ``out_proj`` to frames, laid end
    to end. Weights uniform from ``generator`` (a CPU one): ``proj`` in
    [-0.01, 0.01), ``w_ih``, ``w_hh`` and ``out_proj`` in [-0.1, 0.1)."""

    def __init__(self, control_plane_dim: int, input_dim: int, state_matrix_dim: int,
                 window_size: int, generator: torch.Generator, device=None):
        super().__init__()
        dev = default_device(device)
        self.proj = nn.Parameter(uniform_init((control_plane_dim, input_dim), 0.01,
                                              generator).to(dev))
        self.rnn = nn.RNN(input_dim, state_matrix_dim, nonlinearity="tanh", bias=False,
                          batch_first=True)
        with torch.no_grad():
            self.rnn.weight_ih_l0.copy_(uniform_init((input_dim, state_matrix_dim), 0.1,
                                                     generator).T)
            self.rnn.weight_hh_l0.copy_(uniform_init((state_matrix_dim, state_matrix_dim), 0.1,
                                                     generator).T)
        self.rnn.to(dev)
        self.out_proj = nn.Parameter(uniform_init((state_matrix_dim, window_size), 0.1,
                                                  generator).to(dev))

    def forward(self, control: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = control.shape[0]
        with no_tf32():
            proj = control.transpose(1, 2) @ self.proj
            states, _ = self.rnn(proj)     # h_t = tanh(x_t @ w_ih + h_(t-1) @ w_hh), h_0 = 0
            x = states @ self.out_proj     # (batch, frames, window)
        return x.reshape(batch, 1, -1), x[:, 1:, 0] - x[:, :-1, -1]


class OverfitControlPlane(nn.Module):
    """A learned control plane (1, control_plane_dim, n_frames), uniform in
    [0, 0.1), through ``control_signal`` (the top ``n_active_sites``
    entries, then ``relu``) into an ``InstrumentModel`` (its ``ssm``).
    Parameters from ``init_generator`` (a CPU generator, default seed 0)."""

    def __init__(self, control_plane_dim: int, input_dim: int, state_matrix_dim: int,
                 n_samples: int, window_size: int, n_active_sites: Optional[int] = None,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.control_plane_dim, self.n_samples, self.window_size = (control_plane_dim,
                                                                    n_samples, window_size)
        self.n_active_sites = n_active_sites
        self.control = nn.Parameter(uniform((1, control_plane_dim, self.n_frames), 0.0, 0.1,
                                            gen).to(dev))
        self.ssm = InstrumentModel(control_plane_dim, input_dim, state_matrix_dim, window_size,
                                   gen, dev)

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.window_size

    def control_signal(self, control: torch.Tensor) -> torch.Tensor:
        if self.n_active_sites is not None:
            control = sparsify(control, n_to_keep=self.n_active_sites)
        return torch.relu(control)

    def forward(self, sig: Optional[torch.Tensor] = None):
        return self.ssm(sig if sig is not None else self.control_signal(self.control))

    def random(self, p: float = 0.0001, generator: torch.Generator | None = None,
               draw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Audio, max-normed, from a random control plane of ones with
        probability ``p``, drawn from ``generator`` (on the model's device;
        default one seeded with 0), or ``draw`` when given."""
        if draw is None:
            dev = self.control.device
            gen = generator or torch.Generator(device=dev).manual_seed(0)
            shape = (1, self.control_plane_dim, self.n_frames)
            draw = torch.bernoulli(torch.full(shape, p, device=dev), generator=gen)
        audio, _ = self(sig=draw)
        return max_norm(audio)

    def rolled_control_plane(self, control: Optional[torch.Tensor] = None,
                             generator: torch.Generator | None = None,
                             indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Audio, max-normed, from ``control_signal(control)`` (the model's
        own plane by default) with its channels permuted by ``indices``, or
        by a permutation drawn from ``generator`` (on the model's device;
        default one seeded with 0)."""
        control = self.control if control is None else control
        if indices is None:
            gen = generator or torch.Generator(device=control.device).manual_seed(0)
            indices = torch.randperm(self.control_plane_dim, generator=gen,
                                     device=control.device)
        audio, _ = self(sig=self.control_signal(control)[:, indices, :])
        return max_norm(audio)


def transform(x: torch.Tensor) -> torch.Tensor:
    """The loss's feature: bands from 512 samples up, each by an STFT of
    window 64, step 16, flattened."""
    return flattened_multiband_spectrogram(x, stft_spec={"xs": (64, 16)}, smallest_band_size=512)


def l0_norm(x: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """The count of entries of ``x`` above ``epsilon`` in magnitude."""
    return torch.sum(torch.abs(x) > epsilon)


def param_tree(model: OverfitControlPlane) -> dict:
    """The model's parameters as ``mptpu``'s flax tree of numpy arrays,
    ``{"params": {"control": ..., "ssm": {"out_proj", "proj", "w_hh",
    "w_ih"}}}``, the RNN's weights transposed back."""
    ssm = model.ssm
    arr = lambda t: t.detach().cpu().numpy()
    return {"params": {"control": arr(model.control), "ssm": {
        "out_proj": arr(ssm.out_proj), "proj": arr(ssm.proj),
        "w_hh": arr(ssm.rnn.weight_hh_l0.T), "w_ih": arr(ssm.rnn.weight_ih_l0.T)}}}


def generate_param_dict(model: OverfitControlPlane) -> dict:
    """The weights JSON for the browser synth: for each leaf of
    ``param_tree(model)``, in flax's order and under its path (as
    ``"['params']/['ssm']/['w_ih']"``), its shape and its float32 bytes in
    base64."""
    out = {}

    def walk(node, path):
        for key in sorted(node):
            where = path + [f"['{key}']"]
            if isinstance(node[key], dict):
                walk(node[key], where)
            else:
                arr = np.asarray(node[key], dtype=np.float32)
                out["/".join(where)] = {"shape": list(arr.shape),
                                        "data": base64.b64encode(arr.tobytes()).decode()}

    walk(param_tree(model), [])
    return out


def read_param_dict(weights: dict) -> dict:
    """The flax tree of numpy arrays that ``generate_param_dict`` encoded,
    for ``convert.ssm_from_flax``."""
    tree = {}
    for key, leaf in weights.items():
        names = [part[2:-2] for part in key.split("/")]
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = np.frombuffer(base64.b64decode(leaf["data"]),
                                        np.float32).reshape(leaf["shape"]).copy()
    return tree


def ssm_loss(model: OverfitControlPlane, target_feature: torch.Tensor,
             boundary_weight: float = 1.0) -> torch.Tensor:
    """The script's loss: the l1 distance of the features of the model's
    audio from the target's, plus the frame boundaries' differences in l1
    times ``boundary_weight``."""
    audio, boundary_diff = model()
    recon = kinks.abs(transform(audio) - target_feature).sum()
    return recon + kinks.abs(boundary_diff).sum() * boundary_weight


def make_script_step(loss_fn, opt: torch.optim.Optimizer):
    """``step() -> loss`` with ``scripts/ssm_article.py``'s guard: the
    optimizer always steps, its moments included, and the parameters keep
    their old values where the loss is not finite. (The port's
    ``train.make_train_step`` keeps both.) The choice runs on the device:
    no host read a step. Forward and backward run under ``no_tf32``."""
    params = [p for group in opt.param_groups for p in group["params"]]

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        with no_tf32():
            loss = loss_fn()
            loss.backward()
        kept = [p.detach().clone() for p in params]
        opt.step()
        ok = torch.isfinite(loss.detach())
        with torch.no_grad():
            for p, old in zip(params, kept):
                p.copy_(torch.where(ok, p, old))
        return loss.detach()

    return step


class SSMFit(NamedTuple):
    model: OverfitControlPlane
    losses: List[float]      # every step's loss, warm-up steps first
    steps_per_sec: float     # over the timed steps, host clock
    skipped: int             # steps whose non-finite loss kept the parameters
    target: torch.Tensor     # (1, 1, n_samples)


def train_model_for_segment(n_samples: int = 2**18, window_size: int = 128,
                            control_plane_dim: int = 64, state_dim: int = 128,
                            n_active_sites: int = 512, n_iterations: int = 1000,
                            lr: float = 1e-2, article_path: str | None = None,
                            audio_path: str | None = None, boundary_weight: float = 1.0,
                            seed: int | None = None, warmup: int = 0, device=None,
                            init_generator: torch.Generator | None = None) -> SSMFit:
    """Overfit an ``OverfitControlPlane`` to one segment of
    ``get_one_audio_segment(n_samples, seed=seed)`` with Adam (``lr``,
    optax's defaults: betas 0.9, 0.999, eps 1e-8) and the script's NaN
    guard. ``warmup`` steps run first, then ``n_iterations`` on the host
    clock, ending in a synchronisation on a card; the losses are read once,
    at the end. With ``article_path`` it writes the script's HTML article
    (target, reconstruction, a random control plane from a generator
    seeded with 7 at p 0.001, the plane permuted by one seeded with 8, the
    learned plane) and the weights JSON beside it."""
    dev = default_device(device)
    samplerate = 22050
    target = get_one_audio_segment(n_samples, samplerate, audio_path=audio_path, seed=seed,
                                   device=dev).reshape(1, 1, n_samples)
    model = OverfitControlPlane(control_plane_dim, window_size, state_dim, n_samples,
                                window_size, n_active_sites, init_generator=init_generator,
                                device=dev)
    with torch.no_grad():
        t_spec = transform(target)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_script_step(lambda: ssm_loss(model, t_spec, boundary_weight), opt)

    losses = [step() for _ in range(warmup)]
    t0 = time.perf_counter()
    losses += [step() for _ in range(n_iterations)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steps_per_sec = n_iterations / (time.perf_counter() - t0)
    losses = torch.stack(losses).cpu().tolist() if losses else []
    skipped = sum(not np.isfinite(v) for v in losses)

    if article_path:
        with torch.no_grad():
            audio = max_norm(model()[0])
            random_audio = model.random(0.001, torch.Generator(device=dev).manual_seed(7))
            rolled = model.rolled_control_plane(
                generator=torch.Generator(device=dev).manual_seed(8))
        host = lambda t: t[0, 0].cpu().numpy()
        control = np.abs(model.control.detach().cpu().numpy().reshape(control_plane_dim, -1))
        conjure_article(
            article_path, "Playable State-Space Models From a Single Audio Sample",
            [AudioComponent(host(target), samplerate, "Original"),
             AudioComponent(host(audio), samplerate, "Reconstruction"),
             AudioComponent(host(random_audio), samplerate, "Random sparse control signal"),
             AudioComponent(host(rolled), samplerate, "Permuted control plane"),
             ImageComponent(control, "Learned control signal")],
            intro_markdown=("# Playable state-space model\n"
                            "An SSM 'instrument' extracted from one recording; the sparse "
                            "control plane is the playable surface."))
        with open(article_path.replace(".html", "_weights.json"), "w") as f:
            json.dump(generate_param_dict(model), f)
    return SSMFit(model, losses, steps_per_sec, skipped, target)
