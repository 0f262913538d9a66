"""A playable instrument over a trained SIAM codec (counterpart of
``mptpu/models/instrument.py`` and of ``scripts/instrument.py``): notes
are (vector, onset, gain), rendered each alone through the decoder and
summed.

Each note renders with its own noise, one draw of (1, 1, noise size) a
note, as ``mptpu`` folds note ``i`` into its key; the codec's own noise
(one draw an event index, shared by every call) would give other audio.
The draws are passed in, or drawn in note order from a generator on the
model's device seeded with 0.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, TextIO

import numpy as np
import torch

from ..data.audioiter import AudioIterator
from ..sparse import quantize
from ..train.checkpoint import load_checkpoint
from ..utils.wav import read_wav, write_wav
from .inference import SIAMCodec
from .siam import SIAMModel, draw_noise


def damped_sequential(forces: torch.Tensor, damping: torch.Tensor) -> torch.Tensor:
    """``out[i] = (forces[i] + out[i - 1]) * damping[i]`` along the last
    axis, ``out[-1] = 0``. The linear recurrence ``out[i] = a[i] out[i - 1]
    + b[i]`` (a = damping, b = damping x forces) runs as a scan by
    recursive doubling: log2(n) rounds of whole-tensor products and sums,
    where ``mptpu``'s ``lax.scan`` takes n steps. The sums associate
    otherwise, so the result is ``mptpu``'s within float32 rounding."""
    a = damping
    b = damping * forces
    n = forces.shape[-1]
    k = 1
    while k < n:
        # combine each element with the one k before it: (a, b) after
        # (a', b') is (a a', a b' + b); the first k have nothing before them
        b = torch.cat([b[..., :k], a[..., k:] * b[..., :-k] + b[..., k:]], dim=-1)
        a = torch.cat([a[..., :k], a[..., k:] * a[..., :-k]], dim=-1)
        k *= 2
    return b


@dataclass
class Note:
    """One queued event: a latent vector, an onset in seconds, a gain."""

    vector: np.ndarray
    time_s: float
    amplitude: float = 1.0


class PlayableInstrument:
    """Render user-placed notes through a SIAM decoder. A note's schedule
    is a dirac at its onset's frame within its window; notes past the
    decoder's window are tiled by window. Vectors come from a bank (event
    vectors harvested from real audio by the codec's encode) or from
    seeded random latents."""

    def __init__(self, codec: SIAMCodec, bank: Optional[np.ndarray] = None):
        self.codec = codec
        self.bank = bank
        self.model: SIAMModel = codec.model
        self.samplerate = self.model.samplerate
        self.device = codec.device
        self._notes: List[Note] = []

    # ---- note sources

    def random_vector(self, seed: int = 0) -> np.ndarray:
        """A standard normal latent from a CPU generator seeded with ``seed``
        (``mptpu`` draws from ``PRNGKey(seed)``: other numbers)."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randn((self.model.context_dim,), generator=gen).numpy()

    def bank_vector(self, index: int) -> np.ndarray:
        if self.bank is None or len(self.bank) == 0:
            raise ValueError("no vector bank loaded")
        return np.asarray(self.bank[index % len(self.bank)])

    def harvest_bank(self, audio: torch.Tensor) -> np.ndarray:
        """Fill the bank with the event vectors the codec encodes from
        ``audio`` (1, 1, n_samples)."""
        enc = self.codec.encode(torch.as_tensor(audio).to(self.device))
        self.bank = enc.vecs.reshape(-1, self.model.context_dim).cpu().numpy()
        return self.bank

    # ---- sequencing

    def add_note(self, vector: np.ndarray, time_s: float, amplitude: float = 1.0):
        self._notes.append(Note(np.asarray(vector), float(time_s), float(amplitude)))

    def clear(self):
        self._notes = []

    @property
    def notes(self) -> List[Note]:
        return list(self._notes)

    # ---- rendering

    def _schedule_row(self, time_s: float, amplitude: float) -> np.ndarray:
        """(n_frames,) zeros with ``amplitude`` at the onset's frame: Python's
        ``round`` (half to even) of the frame, clamped to the window."""
        frames = self.model.n_frames
        frame = int(round(time_s * self.samplerate / self.model.transform_step_size))
        frame = max(0, min(frames - 1, frame))
        row = np.zeros((frames,), dtype=np.float32)
        row[frame] = amplitude
        return row

    @torch.no_grad()
    def render(self, notes: Optional[Sequence[Note]] = None,
               total_seconds: Optional[float] = None,
               noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """The queued (or given) notes as one (1, 1, samples) float32 array,
        at least ``total_seconds`` long and one window past the last onset.
        Note ``i`` renders in the window its onset falls in, with
        ``noise[i]`` ((1, 1, noise size)), else the ``i``-th draw of a
        generator on the model's device seeded with 0."""
        notes = list(notes if notes is not None else self._notes)
        n = self.model.n_samples
        if not notes:
            return np.zeros((1, 1, n), dtype=np.float32)
        if noise is None:
            noise = draw_noise(self.model, (len(notes), 1),
                               torch.Generator(device=self.device).manual_seed(0))
        window_s = n / self.samplerate
        total_s = max(total_seconds or 0.0, max(note.time_s for note in notes) + window_s)
        total = int(np.ceil(total_s * self.samplerate))
        out = torch.zeros((1, 1, total + n), device=self.device)
        for i, note in enumerate(notes):
            window_index = int(note.time_s // window_s)
            within = note.time_s - window_index * window_s
            vec = torch.as_tensor(np.array(note.vector, np.float32)).to(self.device)
            sched = torch.from_numpy(self._schedule_row(within, note.amplitude)).to(self.device)
            audio = self.model.generate(vec.reshape(1, 1, -1), sched.reshape(1, 1, -1),
                                        noise=noise[i].to(self.device))
            start = window_index * n
            out[..., start: start + audio.shape[-1]] += audio[0, 0]
        return out[..., :total].cpu().numpy()


# ---- scripts/instrument.py ------------------------------------------------------------------

def build_instrument(checkpoint: Optional[str] = "trained_weights/siam", tiny: bool = False,
                     noise_seed: int = 0, size_overrides: Optional[dict] = None,
                     selection_leak: float = 0.0, selection_floor: float = 0.0,
                     device=None) -> PlayableInstrument:
    """The script's instrument: the tiny model (2^13 samples, context 16,
    hidden 32, 4 events, STFT 512/256), a scaled configuration from
    ``size_overrides`` (``n_samples``, ``context_dim``, ``window``,
    ``hidden``, ``n_events`` and optionally ``attn_floor``, ``attn_leak``),
    or the full default model; its parameters from a ``.pkl`` checkpoint
    file, else the newest checkpoint in the directory ``checkpoint``, else
    its own seeded ones. A non-zero selection leak or floor is set for the
    process, as the script sets them before it builds."""
    if selection_leak or selection_floor:
        quantize.set_selection_leak(selection_leak)
        quantize.set_selection_floor(selection_floor)
    if tiny:
        model = SIAMModel(n_samples=2**13, context_dim=16, in_channels=257, hidden_channels=32,
                          n_events=4, transform_window_size=512, transform_step_size=256,
                          device=device)
    elif size_overrides:
        o = size_overrides
        model = SIAMModel(n_samples=o["n_samples"], context_dim=o["context_dim"],
                          in_channels=o["window"] // 2 + 1, hidden_channels=o["hidden"],
                          n_events=o["n_events"], transform_window_size=o["window"],
                          transform_step_size=256, fft_resonance=True,
                          attn_floor=o.get("attn_floor", 0.0), attn_leak=o.get("attn_leak", 0.0),
                          device=device)
    else:
        model = SIAMModel(device=device)
    if checkpoint and checkpoint.endswith(".pkl"):
        # a checkpoint file, such as an overfit run's ema_best.pkl, which
        # CheckpointManager.latest() does not consider
        payload = load_checkpoint(checkpoint)
        if payload is None:
            raise SystemExit(f"unreadable checkpoint {checkpoint}")
        codec = SIAMCodec(model=model, params=payload["params"], seed=noise_seed)
    else:
        codec = SIAMCodec(model=model, checkpoint_dir=checkpoint, seed=noise_seed)
    return PlayableInstrument(codec)


PHRASE_TIMES = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0)


def demo_phrase(inst: PlayableInstrument, out_path: str, harvest_seed: Optional[int] = None,
                harvest_wav: Optional[str] = None, noise: Optional[torch.Tensor] = None,
                log: Callable[[str], None] = print) -> np.ndarray:
    """The script's demo: with ``harvest_wav`` (its first window) or
    ``harvest_seed`` (a segment of ``AudioIterator``) 7 notes of the
    harvested bank at ``PHRASE_TIMES``, gains 1 - 0.08 i; otherwise 5
    random latents (seeds 0 to 4) at the first five, gains 1 - 0.1 i. The
    phrase is rendered with ``noise`` (default the render's own draws),
    peak-normalised to 0.5 (a gain of at most 1e4) and written to
    ``out_path``."""
    n = inst.model.n_samples
    seg = None
    if harvest_wav is not None:
        wav = np.asarray(read_wav(harvest_wav)[0], dtype=np.float32)[:n]
        if wav.shape[0] < n:
            wav = np.pad(wav, (0, n - wav.shape[0]))
        seg = torch.from_numpy(wav).reshape(1, 1, -1)
    elif harvest_seed is not None:
        seg = next(iter(AudioIterator(1, n, normalize=True, seed=harvest_seed,
                                      device=inst.device)))
    if seg is not None:
        bank = inst.harvest_bank(seg)
        for i, t in enumerate(PHRASE_TIMES):
            inst.add_note(inst.bank_vector(i % bank.shape[0]), t, amplitude=1.0 - 0.08 * i)
    else:
        for i, t in enumerate(PHRASE_TIMES[:5]):
            inst.add_note(inst.random_vector(seed=i), t, amplitude=1.0 - 0.1 * i)
    audio = inst.render(noise=noise)
    # a checkpoint's raw event amplitudes can be tiny: normalise the peak
    # as a synth's output stage would
    peak = float(np.abs(audio).max()) + 1e-9
    gain = min(0.5 / peak, 1e4)
    audio = audio * gain
    log(f"output gain {gain:.1f}x (raw peak {peak:.5f})")
    write_wav(out_path, audio[0, 0], inst.samplerate)
    log(f"wrote {out_path} ({audio.shape[-1]} samples, {audio.shape[-1] / inst.samplerate:.2f}s, "
        f"rms {float(np.sqrt(np.mean(audio**2))):.5f})")
    return audio


def repl(inst: PlayableInstrument, stream: TextIO = sys.stdin,
         log: Callable[[str], None] = print) -> None:
    """The script's command loop over the lines of ``stream`` until
    ``quit`` or its end: ``note <t> [amp] [seed]``, ``vec <i> <t> [amp]``,
    ``harvest`` (a segment of ``AudioIterator``, seed 3), ``render
    [f.wav]``, ``list``, ``clear``."""
    log("mptpu instrument — 'note <t> [amp] [seed]', 'vec <i> <t> [amp]', 'harvest', "
        "'render [f.wav]', 'list', 'clear', 'quit'")
    for line in stream:
        line = line.strip()
        if not line:
            continue
        cmd, *rest = line.split()
        try:
            if cmd == "quit":
                break
            elif cmd == "note":
                t = float(rest[0])
                amp = float(rest[1]) if len(rest) > 1 else 1.0
                seed = int(rest[2]) if len(rest) > 2 else len(inst.notes)
                inst.add_note(inst.random_vector(seed), t, amp)
                log(f"queued note @{t}s amp {amp} (seed {seed})")
            elif cmd == "vec":
                i, t = int(rest[0]), float(rest[1])
                amp = float(rest[2]) if len(rest) > 2 else 1.0
                inst.add_note(inst.bank_vector(i), t, amp)
                log(f"queued bank[{i}] @{t}s amp {amp}")
            elif cmd == "harvest":
                seg = next(iter(AudioIterator(1, inst.model.n_samples, normalize=True, seed=3,
                                              device=inst.device)))
                bank = inst.harvest_bank(seg)
                log(f"bank: {bank.shape[0]} vectors")
            elif cmd == "render":
                path = rest[0] if rest else "instrument_out.wav"
                audio = inst.render()
                write_wav(path, audio[0, 0], inst.samplerate)
                log(f"wrote {path} ({audio.shape[-1]} samples)")
            elif cmd == "list":
                for j, note in enumerate(inst.notes):
                    log(f"{j}: t={note.time_s}s amp={note.amplitude}")
            elif cmd == "clear":
                inst.clear()
                log("cleared")
            else:
                log(f"unknown command {cmd!r}")
        except (IndexError, ValueError) as e:
            log(f"error: {e}")
