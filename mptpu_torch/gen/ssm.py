"""State-space model synthesis (counterpart of ``mptpu/gen/ssm.py``).

``mptpu`` runs the recurrence as a ``lax.scan``; here it is a Python loop
over frames, one matrix product and one sum a frame. The products that do
not feed the recurrence (each input through B and D, each tapped state
through C) are taken for all frames at once, before and after the loop.
The order of a step is ``mptpu``'s: the state goes through A, the output
taps it there, and only then is the input's B added.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..device import default_device
from ..nn.init import uniform_init, uniform_linear
from ..ops.overlap_add import overlap_add
from .generator import EventGenerator, ShapeSpec
from .schedule import DiracScheduler


def _mat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``v @ m``; a 3-D ``m`` holds one matrix per item of the batch."""
    if m.ndim == 3:
        return torch.bmm(v if v.ndim == 3 else v[:, None], m).reshape(*v.shape[:-1], m.shape[-1])
    return v @ m


def ssm_scan(proj: torch.Tensor, state_matrix: torch.Tensor, input_matrix: torch.Tensor,
             output_matrix: torch.Tensor, direct_matrix: torch.Tensor,
             state_dim: int) -> torch.Tensor:
    """(batch, frames, input_dim) -> (batch, frames, input_dim): at each
    frame ``state = state @ A``, ``out = state @ C + inp @ D``, then
    ``state += inp @ B``, from a zero state. Each matrix is 2-D, or 3-D
    with one matrix per item."""
    batch, frames, _ = proj.shape
    b = _mat(proj, input_matrix)
    state = torch.zeros(batch, state_dim, dtype=proj.dtype, device=proj.device)
    tapped = []
    for t in range(frames):
        state = _mat(state, state_matrix)
        tapped.append(state)
        state = state + b[:, t]
    return _mat(torch.stack(tapped, 1), output_matrix) + _mat(proj, direct_matrix)


def state_space_model(control: torch.Tensor, proj_matrix: torch.Tensor,
                      state_matrix: torch.Tensor, input_matrix: torch.Tensor,
                      output_matrix: torch.Tensor, direct_matrix: torch.Tensor,
                      state_matrix_dim: int, input_dim: int, n_samples: int,
                      windowed: bool = True) -> torch.Tensor:
    """control (batch, control_plane_dim, frames) -> audio (batch, 1,
    n_samples): the projection, the scan, then overlap-add of its frames."""
    proj = _mat(control.transpose(1, 2), proj_matrix)
    frames = ssm_scan(proj, state_matrix, input_matrix, output_matrix, direct_matrix,
                      state_matrix_dim)
    return overlap_add(frames[:, None], apply_window=windowed)[..., :n_samples]


class SSM(nn.Module):
    """The five-matrix SSM with learned matrices, each uniform in [-0.01,
    0.01) from ``init_generator`` (a CPU generator, default seed 0):
    (batch, control_plane_dim, frames) -> (batch, 1, frames * input_dim // 2)."""

    def __init__(self, control_plane_dim: int, input_dim: int, state_matrix_dim: int,
                 windowed: bool = True, init_generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.input_dim, self.state_matrix_dim, self.windowed = (input_dim, state_matrix_dim,
                                                               windowed)
        shapes = dict(proj=(control_plane_dim, input_dim),
                      state_matrix=(state_matrix_dim, state_matrix_dim),
                      input_matrix=(input_dim, state_matrix_dim),
                      output_matrix=(state_matrix_dim, input_dim),
                      direct_matrix=(input_dim, input_dim))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(uniform_init(shape, 0.01, gen).to(dev)))

    def forward(self, control: torch.Tensor) -> torch.Tensor:
        return state_space_model(control, self.proj, self.state_matrix, self.input_matrix,
                                 self.output_matrix, self.direct_matrix, self.state_matrix_dim,
                                 self.input_dim, control.shape[-1] * (self.input_dim // 2),
                                 windowed=self.windowed)


class HyperNetworkLayer(nn.Module):
    """A factorised weight generator: latent (..., latent_channels) ->
    one (in, out) matrix per row, the product of two Dense layers' outputs
    (flax's ``Dense_0`` and ``Dense_1``, weights uniform in [-0.1, 0.1),
    biases zero)."""

    def __init__(self, latent_channels: int, layer_latent: int, layer_in_channels: int,
                 layer_out_channels: int, generator: torch.Generator, device=None):
        super().__init__()
        self.layer_latent, self.in_channels, self.out_channels = (
            layer_latent, layer_in_channels, layer_out_channels)
        self.Dense_0 = uniform_linear(latent_channels, layer_latent * layer_in_channels, True,
                                      0.1, generator, device)
        self.Dense_1 = uniform_linear(latent_channels, layer_latent * layer_out_channels, True,
                                      0.1, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.Dense_0(x).reshape(-1, self.in_channels, self.layer_latent)
        b = self.Dense_1(x).reshape(-1, self.layer_latent, self.out_channels)
        return a @ b


# the generator's hypernetworks by flax name: (in, out) widths by attribute
_HYPER = {"state": ("state_dim", "state_dim"), "input": ("input_dim", "state_dim"),
          "output": ("state_dim", "input_dim"), "direct": ("input_dim", "input_dim"),
          "proj": ("control_plane_dim", "input_dim")}


class StateSpaceModelEventGenerator(nn.Module, EventGenerator):
    """An SSM per event whose five matrices hypernetworks make from the
    event's latents, its audio placed by a ``DiracScheduler``. ``forward``
    takes the heads of ``shape_spec``, each (batch, n_events, *shape), and
    returns (batch, n_events, n_samples)."""

    def __init__(self, context_dim: int, control_plane_dim: int, input_dim: int,
                 state_dim: int, hypernetwork_dim: int, hypernetwork_latent: int,
                 n_samples: int, samplerate: int, n_frames: int,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.context_dim, self.control_plane_dim, self.input_dim = (context_dim,
                                                                    control_plane_dim, input_dim)
        self.state_dim, self.hypernetwork_dim = state_dim, hypernetwork_dim
        self.n_samples, self.samplerate, self.n_frames = n_samples, samplerate, n_frames
        for name, (inc, outc) in _HYPER.items():
            setattr(self, name, HyperNetworkLayer(hypernetwork_dim, hypernetwork_latent,
                                                  getattr(self, inc), getattr(self, outc),
                                                  gen, dev))

    @property
    def shape_spec(self) -> ShapeSpec:
        hyper = (1, self.hypernetwork_dim)
        return dict(control_signal=(self.control_plane_dim, self.n_frames),
                    state_matrix_hypervector=hyper, output_matrix_hypervector=hyper,
                    input_matrix_hypervector=hyper, direct_matrix_hypervector=hyper,
                    proj_matrix_hypervector=hyper, times=(self.n_frames,))

    def forward(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        control = torch.relu(params["control_signal"])
        m = {name: getattr(self, name)(params[f"{name}_matrix_hypervector"].reshape(
            -1, self.hypernetwork_dim)) for name in _HYPER}
        final = state_space_model(
            control.reshape(-1, self.control_plane_dim, self.n_frames), m["proj"], m["state"],
            m["input"], m["output"], m["direct"], state_matrix_dim=self.state_dim,
            input_dim=self.input_dim, n_samples=self.n_samples)
        batch = params["control_signal"].shape[0]
        final = final.reshape(batch, -1, self.n_samples)
        return DiracScheduler(1, self.n_frames, self.n_samples).schedule(params["times"], final)
