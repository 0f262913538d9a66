"""Carry weights from the JAX package's arrays into PyTorch tensors.

Anything ``np.asarray`` accepts (a JAX array, a numpy array, a nested
list) converts. For the matching-pursuit encoder the dictionary is the
whole model; for the multiband codec it is one dictionary per band; the
sparsity modules take a flax parameter tree of ``Dense`` layers.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import default_device


def dictionary_from_jax(d, device=None) -> torch.Tensor:
    """An (N, A) or (N, C, A) dictionary as a float32 tensor on
    ``default_device(device)`` (CUDA unless ``"cpu"`` is asked for)."""
    arr = np.asarray(d, dtype=np.float32)
    if arr.ndim not in (2, 3):
        raise ValueError(f"a dictionary is (N, A) or (N, C, A), got shape {arr.shape}")
    return torch.from_numpy(arr.copy()).to(default_device(device))


def params_from_numpy(tree, device=None):
    """Convert every array leaf of a nested dict / list / tuple to a tensor
    on ``default_device(device)``, keeping the structure and each leaf's
    dtype. Other leaves (strings, None) pass through."""
    dev = default_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if node is None or isinstance(node, str):
            return node
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)


def band_dicts_from_jax(model_or_dict, device=None) -> dict:
    """The band dictionaries of a multiband model as float32 tensors on
    ``default_device(device)``, keyed by band size in the same order.

    Takes ``mptpu``'s ``MultibandDictionaryLearning`` (anything with a
    ``band_dicts`` mapping) or such a mapping ``{size: (N, A) array}``
    itself. Give each tensor to the port's ``BandSpec(size, ..., d=...)``
    and both models compute with the same dictionaries.
    """
    dicts = getattr(model_or_dict, "band_dicts", model_or_dict)
    return {int(size): dictionary_from_jax(d, device) for size, d in dicts.items()}


def sparsity_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy the flax parameters of ``mptpu``'s ``ElementwiseSparsity`` or
    ``VectorwiseSparsity`` (``module.init``'s ``{"params": {"Dense_i":
    {"kernel", "bias"}}}``, or its ``"params"`` entry) into the port's
    module of the same shape, in place, and return it. A flax ``kernel`` is
    (in, out) and an ``nn.Linear`` weight (out, in): it is transposed."""
    params = variables.get("params", variables)
    layers = {name for name, m in module.named_children() if isinstance(m, torch.nn.Linear)}
    if set(params) != layers:
        raise ValueError(f"flax layers {sorted(params)} against the module's {sorted(layers)}")
    with torch.no_grad():
        for name, leaf in params.items():
            linear = getattr(module, name)
            weight = np.asarray(leaf["kernel"], dtype=np.float32).T
            bias = np.array(leaf["bias"], dtype=np.float32)
            if weight.shape != tuple(linear.weight.shape) or bias.shape != tuple(linear.bias.shape):
                raise ValueError(
                    f"{name}: kernel {weight.T.shape}, bias {bias.shape} against the module's "
                    f"weight {tuple(linear.weight.shape)} (transposed), bias {tuple(linear.bias.shape)}"
                )
            linear.weight.copy_(torch.from_numpy(weight.copy()))
            linear.bias.copy_(torch.from_numpy(bias))
    return module
