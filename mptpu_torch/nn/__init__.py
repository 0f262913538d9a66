"""Neural-network building blocks of the port (counterpart of
``mptpu.nn``; only the ported names). Children carry flax's names
(``Dense_0``, ``ResidualStack_0``, ``ResidualBlock_0``), so that
``convert.splat_from_flax`` finds every layer by its flax path."""

from .init import uniform, uniform_init, uniform_linear
from .linear import LinearOutputStack, ResidualBlock, ResidualStack
from .multihead import MultiHeadTransform

__all__ = [
    "uniform",
    "uniform_init",
    "uniform_linear",
    "LinearOutputStack",
    "ResidualBlock",
    "ResidualStack",
    "MultiHeadTransform",
]
