"""Selection-type dispatch, item lookup and the quantized resonance mixture
(counterpart of ``mptpu/sparse/quantize.py``)."""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch import nn

from ..device import default_device
from ..ops.kinks import leaky_relu
from ..ops.ste import hard_softmax, sparse_softmax
from ..utils.music import musical_scale_hz


def hard_choice(
    selections: torch.Tensor,
    selection_type: str = "sparse_softmax",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Selection weights over the last axis. ``gumbel_softmax`` draws its
    noise from ``generator`` (one on the selections' device), where
    ``mptpu`` takes a PRNG key."""
    if selection_type == "sparse_softmax":
        return sparse_softmax(selections, normalize=True, axis=-1)
    if selection_type == "identity":
        return selections
    if selection_type == "gumbel_softmax":
        if generator is None:
            raise ValueError("gumbel_softmax selection requires a torch.Generator")
        return hard_softmax(selections, axis=-1, tau=0.1, generator=generator)
    if selection_type == "softmax":
        return torch.softmax(selections, dim=-1)
    if selection_type == "relu":
        if RELU_SELECTION_LEAK:
            # opt-in training aid (set_selection_leak): a relu selection whose
            # logits are all negative is exactly silent and passes no gradient
            sel = leaky_relu(selections, RELU_SELECTION_LEAK)
        else:
            sel = torch.relu(selections)
        if RELU_SELECTION_FLOOR:
            # opt-in training aid (set_selection_floor): the leak mends the
            # backward only; a floor keeps a dead event audible in the forward
            sel = sel + RELU_SELECTION_FLOOR
        return sel
    raise ValueError(f"{selection_type} is an unknown selection type")


# Knobs of the 'relu' selection type, read at every call. 0.0 (the default)
# is mptpu's default; trainers may set small values (e.g. 0.01).
RELU_SELECTION_LEAK: float = 0.0
RELU_SELECTION_FLOOR: float = 0.0


def set_selection_leak(leak: float) -> None:
    """Set the leaky-relu slope of 'relu' selections (0 = plain relu)."""
    global RELU_SELECTION_LEAK
    RELU_SELECTION_LEAK = float(leak)


def set_selection_floor(floor: float) -> None:
    """Set the additive floor on 'relu' selection weights (0 = none)."""
    global RELU_SELECTION_FLOOR
    RELU_SELECTION_FLOOR = float(floor)


@contextmanager
def selection_knobs(leak: float, floor: float):
    """The 'relu' selections' leak and floor set for the block, whatever
    they were, and restored after it."""
    saved = (RELU_SELECTION_LEAK, RELU_SELECTION_FLOOR)
    set_selection_leak(leak)
    set_selection_floor(floor)
    try:
        yield
    finally:
        set_selection_leak(saved[0])
        set_selection_floor(saved[1])


def select_items(
    selections: torch.Tensor,
    items: torch.Tensor,
    selection_type: str = "sparse_softmax",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``hard_choice(selections) @ items``."""
    return hard_choice(selections, selection_type, generator=generator) @ items


class QuantizedResonanceMixture(nn.Module):
    """Latent -> quantized code (sparse softmax) -> relu mixture over a
    saw / square / triangle / sine table of ``n_resonances // 4`` pitches.

    ``to_quantized`` (n_resonances, quantize_dim) and ``to_choice``
    (quantize_dim, n_resonances) are drawn uniformly in +-1/sqrt(fan-in)
    from ``generator`` (a CPU ``torch.Generator``, default seed 0); the
    names are those of ``mptpu``'s parameter dict, so ``load_state_dict(
    convert.params_from_numpy(params))`` takes ``mptpu``'s parameters.
    """

    def __init__(
        self,
        n_resonances: int,
        quantize_dim: int,
        n_samples: int,
        samplerate: int,
        generator: torch.Generator | None = None,
        device=None,
    ):
        from ..gen.transfer import make_waves   # here: gen's modules import this one

        super().__init__()
        dev = default_device(device)
        self.n_resonances = n_resonances
        self.quantize_dim = quantize_dim
        self.n_samples = n_samples
        f0s = musical_scale_hz(start_midi=21, stop_midi=106, n_steps=n_resonances // 4)
        waves = make_waves(n_samples, f0s.tolist(), samplerate, device=dev)
        self.register_buffer("waves", waves.reshape(1, n_resonances, n_samples), persistent=False)
        gen = generator or torch.Generator().manual_seed(0)

        def uniform(shape, fan_in):
            lim = 1.0 / math.sqrt(fan_in)
            return nn.Parameter((torch.rand(shape, generator=gen) * 2.0 - 1.0).mul(lim).to(dev))

        self.to_quantized = uniform((n_resonances, quantize_dim), n_resonances)
        self.to_choice = uniform((quantize_dim, n_resonances), quantize_dim)

    def forward(self, x: torch.Tensor, return_code: bool = False):
        quantized = sparse_softmax(x @ self.to_quantized, normalize=True, axis=-1)
        choice = torch.relu(quantized @ self.to_choice)
        resonances = choice @ self.waves
        if return_code:
            return quantized, resonances
        return resonances
