"""The synth-preset embedding worker (counterpart of ``scripts/worker.py``):
take synth presets from an inbox, render each to audio, embed the render
with the SIAM encoder's event vectors and a random projection, and post an
index chunk for it to an outbox.

The transports plug in: an inbox has ``pending()`` (its presets as (key,
JSON dict) pairs, in order) and ``ack(key)``; an outbox has ``post(chunk)``.
A path stands for a directory of ``<preset_id>.json`` files either way
(:class:`DirectoryInbox`, :class:`DirectoryOutbox`), as the script's.

One difference from the script, by design: the script seeds an ``ssm``
preset's synth with Python's ``hash`` of its id, which changes from one
process to the next; the port seeds it with the id's CRC-32
(:func:`preset_seed`), so that a preset renders alike in every run.
"""

from __future__ import annotations

import json
import math
import os
import time
import zlib
from dataclasses import asdict, dataclass
from typing import Callable, Iterator, List, Optional, Tuple

import torch

from .. import convert
from ..device import default_device, no_tf32
from ..train import CheckpointManager
from .siam import SIAMModel, draw_noise, make_iterative_fn
from .ssm_overfit import OverfitControlPlane


@dataclass
class SynthPreset:
    preset_id: str
    synth: str
    params: dict


@dataclass
class IndexChunk:
    preset_id: str
    embedding: List[float]


class DirectoryInbox:
    """Presets as ``*.json`` files of a directory, taken in name order and
    removed once embedded."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def pending(self) -> Iterator[Tuple[str, dict]]:
        for name in sorted(f for f in os.listdir(self.path) if f.endswith(".json")):
            with open(os.path.join(self.path, name)) as f:
                yield name, json.load(f)

    def ack(self, key: str) -> None:
        os.remove(os.path.join(self.path, key))


class DirectoryOutbox:
    """Index chunks written as ``<preset_id>.json`` into a directory."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def post(self, chunk: IndexChunk) -> str:
        out = os.path.join(self.path, f"{chunk.preset_id}.json")
        with open(out, "w") as f:
            json.dump(asdict(chunk), f)
        return out


def preset_seed(preset_id: str) -> int:
    """The seed of an ``ssm`` preset's synth: the CRC-32 of its id."""
    return zlib.crc32(preset_id.encode()) % 2**31


def render_preset(preset: SynthPreset, n_samples: int, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """A preset's audio (1, 1, n_samples): the ``ssm`` synth is an
    ``OverfitControlPlane`` of the preset's sizes with parameters seeded by
    :func:`preset_seed`, played from its own control plane; any other synth
    renders normal noise at 0.1 from ``generator`` (one on the device,
    seeded 0, when None)."""
    dev = default_device(device)
    if preset.synth == "ssm":
        p = preset.params
        model = OverfitControlPlane(
            control_plane_dim=int(p.get("control_plane_dim", 16)),
            input_dim=int(p.get("window_size", 64)),
            state_matrix_dim=int(p.get("state_dim", 32)),
            n_samples=n_samples, window_size=int(p.get("window_size", 64)),
            init_generator=torch.Generator().manual_seed(preset_seed(preset.preset_id)),
            device=dev)
        with torch.no_grad():
            audio, _ = model()
        return audio.reshape(1, 1, n_samples)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    return torch.randn((1, 1, n_samples), generator=gen, device=dev) * 0.1


def make_embedder(model: SIAMModel, dim: int = 128, proj: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None):
    """``embed(audio (1, 1, n)) -> (dim,)``: the event vectors of the
    model's iterative decomposition, flattened, times a normal projection
    scaled by 1 / sqrt(context x events). ``proj`` (context x events, dim)
    and ``noise`` (the decoder's draw, the same for every call) come from a
    generator on the model's device seeded 0 when None."""
    dev = model.to_event_switch.weight.device
    width = model.context_dim * model.n_events
    gen = torch.Generator(device=dev).manual_seed(0)
    if proj is None:
        proj = torch.randn((width, dim), generator=gen, device=dev) / math.sqrt(width)
    if noise is None:
        noise = draw_noise(model, (model.n_events, 1), gen)
    proj, noise = proj.to(dev, torch.float32), noise.to(dev)
    iterative = make_iterative_fn(model)

    @torch.no_grad()
    def embed(audio: torch.Tensor) -> torch.Tensor:
        _, vecs, _, _ = iterative(audio, noise)
        with no_tf32():
            return (vecs.reshape(1, -1) @ proj)[0]

    return embed


def worker_model(tiny: bool = True, checkpoint_dir: Optional[str] = None,
                 device=None) -> SIAMModel:
    """The script's encoder (``--tiny``'s widths or ``SIAMModel()``'s
    defaults) with the newest checkpoint of ``checkpoint_dir`` when there is
    one, else parameters from a generator seeded 0."""
    dev = default_device(device)
    if tiny:
        model = SIAMModel(n_samples=2**12, context_dim=8, in_channels=257, hidden_channels=16,
                          n_events=2, transform_window_size=512, transform_step_size=256,
                          fft_resonance=True, device=dev)
    else:
        model = SIAMModel(device=dev)
    payload = CheckpointManager(checkpoint_dir).latest() if checkpoint_dir else None
    if payload:
        convert.siam_from_flax(model, payload["params"])
    return model.eval()


def run_worker(inbox, outbox, once: bool = False, tiny: bool = True,
               checkpoint_dir: Optional[str] = None, poll_seconds: float = 5.0,
               proj: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               render: Optional[Callable[[SynthPreset, int], torch.Tensor]] = None,
               device=None, log: Callable[[str], None] = print) -> List[IndexChunk]:
    """Embed every preset of ``inbox`` into an index chunk posted to
    ``outbox`` (each a transport or a directory's path), polling every
    ``poll_seconds`` until stopped, or once with ``once``; returns the
    chunks posted. ``render(preset, n_samples)`` makes a preset's audio
    (:func:`render_preset` on the device by default); ``proj`` and ``noise``
    are the embedder's (:func:`make_embedder`). ``device``: ``cuda`` unless
    ``"cpu"``."""
    dev = default_device(device)
    inbox = DirectoryInbox(inbox) if isinstance(inbox, str) else inbox
    outbox = DirectoryOutbox(outbox) if isinstance(outbox, str) else outbox
    model = worker_model(tiny, checkpoint_dir, dev)
    embed = make_embedder(model, proj=proj, noise=noise)
    render = render or (lambda preset, n: render_preset(preset, n, device=dev))
    posted = []
    while True:
        for key, raw in list(inbox.pending()):
            preset = SynthPreset(**raw)
            t0 = time.perf_counter()
            emb = embed(render(preset, model.n_samples).to(dev))
            chunk = IndexChunk(preset_id=preset.preset_id, embedding=emb.cpu().tolist())
            where = outbox.post(chunk)
            inbox.ack(key)
            posted.append(chunk)
            log(f"embedded {preset.preset_id} -> {where} "
                f"({1e3 * (time.perf_counter() - t0):.1f} ms)")
        if once:
            return posted
        time.sleep(poll_seconds)
