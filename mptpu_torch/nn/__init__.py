"""Neural-network building blocks of the port (counterpart of
``mptpu.nn``; only the ported names). Children carry flax's names
(``Dense_0``, ``ResidualStack_0``, ``ResidualBlock_0``, ``Conv_0``), so
that ``convert.splat_from_flax`` and ``convert.siam_from_flax`` find every
layer by its flax path."""

from .anticausal import AntiCausalAnalysis
from .init import uniform, uniform_init, uniform_linear
from .linear import LinearOutputStack, ResidualBlock, ResidualStack
from .multihead import MultiHeadTransform
from .pos_encode import pos_encoded

__all__ = [
    "AntiCausalAnalysis",
    "pos_encoded",
    "uniform",
    "uniform_init",
    "uniform_linear",
    "LinearOutputStack",
    "ResidualBlock",
    "ResidualStack",
    "MultiHeadTransform",
]
