"""The trained SIAM model as an encode / decode / embed service
(counterpart of ``mptpu/models/inference.py``), and the wire quantization
of its events (counterpart of ``quantize_events`` in
``scripts/codec_rate.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import siam_from_flax
from ..device import no_tf32
from ..train.checkpoint import CheckpointManager
from .siam import (SIAMModel, draw_noise, make_iterative_fn, refine_event_alignment,
                   refit_event_gains, streaming_encode)


class SIAMEncoding(NamedTuple):
    """The codec's sparse representation of a segment. ``gains`` and
    ``shifts`` are the optional encode-time corrections of
    :func:`refine_event_alignment` (two scalars per event on the wire);
    None when encoding without refinement."""

    vecs: torch.Tensor       # (batch, n_events, context_dim)
    schedules: torch.Tensor  # (batch, n_events, n_frames)
    channels: torch.Tensor   # (batch, n_events, n_samples) rendered events
    gains: Optional[torch.Tensor] = None   # (batch, n_events)
    shifts: Optional[torch.Tensor] = None  # (batch, n_events) samples


def quantize_events(vecs: torch.Tensor, schedules: torch.Tensor, preset: str = "f16"):
    """(vecs, schedules) -> (dequantized vecs, dequantized schedules, wire
    bytes per event): what the wire carries of each event, decoded.

    A schedule goes on the wire as its argmax frame (u16) and peak
    amplitude (f16) and decodes to a one-hot. The vector is ``"f16"`` (C x
    f16) or ``"int8"`` (C x i8 of its largest magnitude, that scale one
    f16)."""
    c = vecs.shape[-1]
    idx = torch.argmax(schedules, dim=-1)
    amp16 = schedules.gather(-1, idx[..., None]).half().float()
    sched_q = F.one_hot(idx, schedules.shape[-1]).to(torch.float32) * amp16
    if preset == "f16":
        vecs_q = vecs.half().float()
        vec_bytes = 2 * c
    elif preset == "int8":
        scale = torch.clamp_min(torch.amax(torch.abs(vecs), dim=-1, keepdim=True), 1e-12)
        q = torch.clamp(torch.round(vecs / scale * 127.0), -127, 127)
        vecs_q = q / 127.0 * scale.half().float()
        vec_bytes = c + 2
    else:
        raise ValueError(f"unknown wire preset {preset!r}")
    return vecs_q, sched_q, vec_bytes + 2 + 2


def _is_flax_tree(params) -> bool:
    return any(isinstance(v, dict) for v in params.values())


class SIAMCodec:
    """A SIAM model served for encode, decode, reconstruct and embed.

    The parameters come from ``params`` (the port's ``state_dict``, or a
    flax tree such as ``mptpu``'s ``load_checkpoint(path)["params"]``,
    carried by ``convert.siam_from_flax``), else from the newest
    checkpoint in ``checkpoint_dir``, else the model keeps its own. The
    decoder's noise, one draw per event shared by every call, is ``noise``
    ((n_events, batch or 1, 1, model.noise_size)) or a draw from a
    generator seeded with ``seed`` on the model's device; ``mptpu`` folds
    event ``i`` into ``PRNGKey(seed)`` instead.
    """

    def __init__(self, model: Optional[SIAMModel] = None,
                 checkpoint_dir: Optional[str] = "trained_weights/siam", params=None,
                 seed: int = 0, noise: Optional[torch.Tensor] = None, device=None):
        self.model = model or SIAMModel(device=device)
        self.device = next(self.model.parameters()).device
        self.seed = seed
        if params is None and checkpoint_dir:
            payload = CheckpointManager(checkpoint_dir).latest()
            params = payload["params"] if payload is not None else None
        if params is not None:
            if _is_flax_tree(params):
                siam_from_flax(self.model, params)
            else:
                self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        self.model.eval()
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = draw_noise(self.model, (self.model.n_events, 1), gen)
        self.noise = noise.to(self.device)
        self._iterative = make_iterative_fn(self.model)

    @torch.no_grad()
    def encode(self, audio: torch.Tensor, refine: bool = False,
               max_shift: int = 256) -> SIAMEncoding:
        """Fixed-length segment (batch, 1, n_samples) -> sparse events;
        ``refine=True`` adds the shift and gain corrections against
        ``audio``, which :meth:`decode` applies."""
        channels, vecs, schedules, _ = self._iterative(audio, self.noise)
        if not refine:
            return SIAMEncoding(vecs, schedules, channels)
        _, shifts, gains = refine_event_alignment(audio, channels, max_shift=max_shift)
        return SIAMEncoding(vecs, schedules, channels, gains, shifts)

    @torch.no_grad()
    def render(self, vecs: torch.Tensor, schedules: torch.Tensor) -> torch.Tensor:
        """Each event (batch, n_events, ...) rendered alone with its noise:
        channels (batch, n_events, n_samples)."""
        return torch.cat([self.model.generate(vecs[:, i: i + 1], schedules[:, i: i + 1],
                                              noise=self.noise[i])
                          for i in range(vecs.shape[1])], dim=1)

    @torch.no_grad()
    def decode(self, encoding: SIAMEncoding) -> torch.Tensor:
        """Events -> audio (batch, 1, n): each event rendered again and
        summed, with the encode-time shifts and gains when present."""
        channels = self.render(encoding.vecs, encoding.schedules)
        if encoding.shifts is not None:
            n = channels.shape[-1]
            idx = (torch.arange(n, device=channels.device) - encoding.shifts[..., None]) % n
            channels = channels.gather(-1, idx)
        if encoding.gains is not None:
            with no_tf32():
                return torch.einsum("be,ben->bn", encoding.gains, channels)[:, None]
        return torch.sum(channels, dim=1, keepdim=True)

    @torch.no_grad()
    def reconstruct(self, audio: torch.Tensor, refit: bool = False) -> torch.Tensor:
        """Encode and sum; ``refit=True`` re-projects the amplitudes
        against ``audio`` (:func:`refit_event_gains`)."""
        channels = self.encode(audio).channels
        if refit:
            gains = refit_event_gains(audio, channels)
            with no_tf32():
                return torch.einsum("be,ben->bn", gains, channels)[:, None]
        return torch.sum(channels, dim=1, keepdim=True)

    def encode_streaming(self, audio: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """Audio (1, 1, n) of any length through the half-overlap window
        walk; each window draws its own noise from a generator seeded with
        ``seed`` unless ``noise`` ((n_windows, n_events, 1, 1, noise_size))
        is given."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return streaming_encode(self.model, audio, noise, gen)

    def embed(self, audio: torch.Tensor) -> np.ndarray:
        """Flat event-vector embedding (batch, n_events * context_dim) for
        similarity search."""
        return self.encode(audio).vecs.reshape(audio.shape[0], -1).cpu().numpy()
