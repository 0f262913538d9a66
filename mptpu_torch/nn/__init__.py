"""Neural-network building blocks of the port (counterpart of
``mptpu.nn``). Children carry flax's names (``Dense_0``,
``ResidualStack_0``, ``Conv_0``, ``BatchNorm_0``, ...), so that the
converters of ``convert.py`` find every layer by its flax path;
``layers.py`` holds the flax layers whose semantics PyTorch's differ
from."""

from .anticausal import AntiCausalAnalysis
from .dilated import DilatedBlock, DilatedStack
from .init import (flax_linear, lecun_normal, uniform, uniform_init, uniform_linear,
                   uniform_range_init)
from .layers import BatchNorm, ConvTranspose1d, LayerNorm, dropout
from .linear import LinearOutputStack, ResidualBlock, ResidualStack
from .mixer import MixerAttention, MixerBlock, MixerStack
from .multihead import MultiHeadTransform
from .pos_encode import pos_encoded
from .transformer import (FourierMixer, ForwardBlock, MetaFormer, MetaFormerBlock, Transformer,
                          fourier_mix)
from .unet import DownsamplingDiscriminator, UNet
from .upsample import ConvUpsample

__all__ = [
    "AntiCausalAnalysis",
    "DilatedBlock",
    "DilatedStack",
    "pos_encoded",
    "flax_linear",
    "lecun_normal",
    "uniform",
    "uniform_init",
    "uniform_linear",
    "uniform_range_init",
    "BatchNorm",
    "ConvTranspose1d",
    "LayerNorm",
    "dropout",
    "LinearOutputStack",
    "ResidualBlock",
    "ResidualStack",
    "MixerAttention",
    "MixerBlock",
    "MixerStack",
    "MultiHeadTransform",
    "FourierMixer",
    "ForwardBlock",
    "MetaFormer",
    "MetaFormerBlock",
    "Transformer",
    "fourier_mix",
    "DownsamplingDiscriminator",
    "UNet",
    "ConvUpsample",
]
