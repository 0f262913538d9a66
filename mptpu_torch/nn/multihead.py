"""One MLP head per entry of an event generator's ``shape_spec``
(counterpart of ``mptpu/nn/multihead.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .linear import LinearOutputStack

ShapeSpec = Dict[str, Tuple[int, ...]]


class MultiHeadTransform(nn.ModuleDict):
    """(batch, n_events, latent) -> {name: (batch, n_events, *shape)}: a
    ``LinearOutputStack`` per name, in-projection from ``latent_dim``,
    unit-normed residual blocks, built in ``sorted(shapes)`` order (the
    order in which they draw from ``generator``) as the entries
    ``"head_<name>"``."""

    def __init__(self, latent_dim: int, hidden_channels: int, shapes: ShapeSpec, n_layers: int,
                 init_scale: float = 0.1, generator: torch.Generator | None = None, device=None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.shapes = {name: tuple(shapes[name]) for name in sorted(shapes)}
        for name, shape in self.shapes.items():
            self[f"head_{name}"] = LinearOutputStack(
                hidden_channels, n_layers, out_channels=int(np.prod(shape)),
                in_channels=latent_dim, unit_norm_out=True, init_scale=init_scale,
                generator=gen, device=device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch, n_events, _ = x.shape
        return {name: self[f"head_{name}"](x).reshape(batch, n_events, *shape)
                for name, shape in self.shapes.items()}
