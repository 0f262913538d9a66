"""Event-generator contract (counterpart of ``mptpu/gen/generator.py``).

A generator declares its latent heads as ``shape_spec: {name: shape}``;
``nn.MultiHeadTransform`` builds one MLP head per entry, and the
generator's forward takes the resulting dict of tensors.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Tuple

ShapeSpec = Dict[str, Tuple[int, ...]]


class EventGenerator(ABC):
    @property
    @abstractmethod
    def shape_spec(self) -> ShapeSpec:
        ...
