"""The complex-spectral SSM, sized as a compression model (counterpart of
``mptpu/gen/ssm_complex.py``): control frames move into rFFT space over
the control-plane axis, all five matrices are complex, and each output
frame returns to the time domain by an inverse rFFT before overlap-add.
The parameter count is the codec's rate.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import default_device
from ..nn.init import uniform
from ..ops.fft import real_ends
from ..ops.overlap_add import overlap_add
from .ssm import ssm_scan


def _complex_uniform(shape, generator: torch.Generator, lo: float = -0.01,
                     hi: float = 0.01) -> torch.Tensor:
    """complex64 with real and imaginary parts each uniform in [lo, hi),
    the real part drawn first."""
    return torch.complex(uniform(shape, lo, hi, generator), uniform(shape, lo, hi, generator))


class ComplexSSM(nn.Module):
    """(batch, control_plane_dim, frames) -> (batch, 1, frames * input_dim // 2).

    With ``complex_domain=True`` the recurrence runs on rFFT coefficients,
    each width d becoming d // 2 + 1, and its parameters are complex64;
    otherwise it is the real SSM with float32 parameters. Every parameter
    is uniform in [-0.01, 0.01) from ``init_generator`` (a CPU generator,
    default seed 0), the real and imaginary parts each so."""

    def __init__(self, control_plane_dim: int, input_dim: int, state_matrix_dim: int,
                 complex_domain: bool = True, windowed: bool = True,
                 init_generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.input_dim, self.complex_domain, self.windowed = input_dim, complex_domain, windowed
        dims = (control_plane_dim, input_dim, state_matrix_dim)
        if complex_domain:
            dims = tuple(d // 2 + 1 for d in dims)
            init = _complex_uniform
        else:
            init = lambda shape, g: uniform(shape, -0.01, 0.01, g)
        cdim, idim, sdim = dims
        self.state_dim = sdim
        shapes = dict(proj=(cdim, idim), state_matrix=(sdim, sdim), input_matrix=(idim, sdim),
                      output_matrix=(sdim, idim), direct_matrix=(idim, idim))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(init(shape, gen).to(dev)))

    def forward(self, control: torch.Tensor) -> torch.Tensor:
        n_samples = control.shape[-1] * (self.input_dim // 2)
        x = control.transpose(1, 2)
        if self.complex_domain:
            x = torch.fft.rfft(x, dim=-1)
        outs = ssm_scan(x @ self.proj, self.state_matrix, self.input_matrix,
                        self.output_matrix, self.direct_matrix, self.state_dim)
        result = outs[:, None]
        if self.complex_domain:
            result = torch.fft.irfft(real_ends(result), n=self.input_dim, dim=-1)
        return overlap_add(result, apply_window=self.windowed)[..., :n_samples]


class CompressionModel(nn.Module):
    """A learned control plane (1, control_plane_dim, n_frames), uniform in
    [-0.01, 0.01), through ``relu`` into a ``ComplexSSM`` (its ``ssm``). The
    defaults are the codec's: 2^17 samples, window 1024, control 32, state
    64; ``param_count`` of its parameters is the compressed size."""

    def __init__(self, control_plane_dim: int = 32, input_dim: int = 1024,
                 state_matrix_dim: int = 64, n_samples: int = 2**17,
                 complex_domain: bool = True, init_generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        dev = default_device(device)
        gen = init_generator or torch.Generator().manual_seed(0)
        self.n_samples, self.input_dim = n_samples, input_dim
        self.control = nn.Parameter(
            uniform((1, control_plane_dim, self.n_frames), -0.01, 0.01, gen).to(dev))
        self.ssm = ComplexSSM(control_plane_dim, input_dim, state_matrix_dim,
                              complex_domain=complex_domain, init_generator=gen, device=dev)

    @property
    def n_frames(self) -> int:
        return self.n_samples // (self.input_dim // 2)

    def forward(self, sig: torch.Tensor | None = None) -> torch.Tensor:
        return self.ssm(sig if sig is not None else torch.relu(self.control))


def param_count(params) -> int:
    """Real numbers in ``params`` (a module, or an iterable of tensors or
    arrays), a complex number counting as two."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    total = 0
    for x in params:
        n = int(np.prod(x.shape))
        total += 2 * n if (x.is_complex() if isinstance(x, torch.Tensor)
                           else np.iscomplexobj(x)) else n
    return total
