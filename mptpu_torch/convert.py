"""Carry weights from the JAX package's arrays into PyTorch tensors.

Anything ``np.asarray`` accepts (a JAX array, a numpy array, a nested
list) converts. For the matching-pursuit encoder the dictionary is the
whole model; for the multiband codec it is one dictionary per band; the
sparsity modules, the splat overfit and the models after them take a flax
parameter tree, whose ``Dense`` layers and parameters the port's modules
hold under the same names; a tree's ``batch_stats`` go into the port's
``BatchNorm`` buffers.
"""

from __future__ import annotations

import warnings

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
        if isinstance(node, tuple) and hasattr(node, "_fields"):   # a NamedTuple (AdamState)
            return type(node)(*(conv(v) for v in node))
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


def _copy_dense(linear: torch.nn.Linear, leaf, path: str) -> None:
    """Copy a flax ``Dense`` (``{"kernel": (in, out)[, "bias": (out,)]}``)
    into ``linear``: the kernel transposed into the weight; the bias only
    where both have one. Raises on any other name or shape."""
    if set(leaf) - {"kernel", "bias"} or ("bias" in leaf) != (linear.bias is not None):
        raise ValueError(f"{path}: flax entries {sorted(leaf)} against an nn.Linear "
                         f"{'with' if linear.bias is not None else 'without'} bias")
    weight = np.asarray(leaf["kernel"], dtype=np.float32).T
    if weight.shape != tuple(linear.weight.shape):
        raise ValueError(f"{path}: kernel {weight.T.shape} against the module's weight "
                         f"{tuple(linear.weight.shape)} (transposed)")
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(weight.copy()))
        if linear.bias is not None:
            bias = np.array(leaf["bias"], dtype=np.float32)
            if bias.shape != tuple(linear.bias.shape):
                raise ValueError(f"{path}: bias {bias.shape} against the module's "
                                 f"{tuple(linear.bias.shape)}")
            linear.bias.copy_(torch.from_numpy(bias))


def _copy_conv(conv: torch.nn.Conv1d, leaf, path: str) -> None:
    """Copy a flax ``Conv`` (``{"kernel": (k, in, out), "bias": (out,)}``)
    into ``conv``, whose weight is (out, in, k). Raises on any other name
    or shape."""
    if set(leaf) != {"kernel", "bias"} or conv.bias is None:
        raise ValueError(f"{path}: flax entries {sorted(leaf)} against an nn.Conv1d")
    weight = np.asarray(leaf["kernel"], dtype=np.float32).transpose(2, 1, 0)
    bias = np.array(leaf["bias"], dtype=np.float32)
    if weight.shape != tuple(conv.weight.shape) or bias.shape != tuple(conv.bias.shape):
        raise ValueError(f"{path}: kernel {weight.T.shape} and bias {bias.shape} against the "
                         f"module's weight {tuple(conv.weight.shape)} (out, in, k)")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight.copy()))
        conv.bias.copy_(torch.from_numpy(bias))


def _copy_tree(module: torch.nn.Module, tree, path: str) -> None:
    """Copy a flax parameter tree into ``module`` by name: a ``Dense`` leaf
    into the ``nn.Linear`` child of its name, a ``Conv`` leaf into the
    ``nn.Conv1d`` of its name, an array into the parameter of its name, a
    subtree into the child of its name; a real array into a complex
    parameter as complex64, a complex one into a real parameter not at all.
    The names must be exactly the module's own parameters and its children
    that hold any."""
    own = {name for name, _ in module.named_parameters(recurse=False)}
    own |= {name for name, child in module.named_children()
            if next(child.parameters(), None) is not None}
    if set(tree) != own:
        raise ValueError(f"{path or 'the tree'}: flax names {sorted(tree)} against the "
                         f"module's {sorted(own)}")
    for name, node in tree.items():
        where = f"{path}/{name}" if path else name
        target = getattr(module, name)
        if isinstance(target, torch.nn.Linear):
            if not isinstance(node, dict):
                raise ValueError(f"{where}: an array against an nn.Linear")
            _copy_dense(target, node, where)
        elif isinstance(target, torch.nn.Conv1d):
            if not isinstance(node, dict):
                raise ValueError(f"{where}: an array against an nn.Conv1d")
            _copy_conv(target, node, where)
        elif isinstance(target, torch.nn.Parameter):
            if isinstance(node, dict):
                raise ValueError(f"{where}: a subtree against a parameter")
            if np.iscomplexobj(node) and not target.is_complex():
                raise ValueError(f"{where}: a complex array against a real parameter")
            arr = np.asarray(node, dtype=np.complex64 if target.is_complex() else np.float32)
            if arr.shape != tuple(target.shape):
                raise ValueError(f"{where}: shape {arr.shape} against the parameter's "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(arr.copy()))
        elif isinstance(node, dict):
            _copy_tree(target, node, where)
        else:
            raise ValueError(f"{where}: an array against a module")


# the splat model's top-level flax modules and the port's attributes for them
SPLAT_CHILDREN = {"MultiHeadTransform_0": "transform", "SplattingEventGenerator_0": "decoder"}


def splat_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a flax tree of the splat model (``{"params": ...}`` or its
    ``"params"`` entry) into the port's module of the same configuration,
    in place, and return it: ``OverfitHierarchicalEvents.init``'s tree into
    an ``OverfitHierarchicalEvents`` (the event and time parameters, every
    head of ``MultiHeadTransform_0``, the port's ``transform``, and the
    reverb MLPs of ``SplattingEventGenerator_0``, its ``decoder``), or the
    tree of one of its parts (a ``SplattingEventGenerator``, a
    ``MultiHeadTransform``, a ``LinearOutputStack``) into that part. Raises
    on any name or shape that does not match."""
    params = variables.get("params", variables)
    _copy_tree(module, {SPLAT_CHILDREN.get(k, k): v for k, v in params.items()}, "")
    return module


# SIAM layers that a flag of the model builds, by flax name
SIAM_FLAGGED = {"spec_skip_proj": "spectral_skip", "spec_filter_gate": "spectral_filter"}


def siam_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a flax tree of ``mptpu``'s ``SIAMModel`` (``{"params": ...}``
    or its ``"params"`` entry, e.g. a checkpoint's) into the port's
    ``SIAMModel``, in place, and return it. The model is built from its
    own flags: the tree's layer of a flag the model has off
    (``spec_skip_proj``, ``spec_filter_gate``; flax ignores such a leaf
    too) is skipped with a warning that names it. Raises on any other
    name or shape that does not match."""
    params = variables.get("params", variables)
    skipped = sorted(k for k, flag in SIAM_FLAGGED.items()
                     if k in params and not getattr(module, flag))
    if skipped:
        warnings.warn(f"siam_from_flax: skipped {skipped}, layers of flags the model has off",
                      stacklevel=2)
    _copy_tree(module, {k: v for k, v in params.items() if k not in skipped}, "")
    return module


# the song splat's flax names (its setup's) that the port holds elsewhere
SONGSPLAT_CHILDREN = {"generator": "decoder"}


def songsplat_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a flax tree of ``mptpu``'s ``SongSplatModel`` (``{"params":
    ...}`` or its ``"params"`` entry: ``events``, ``times``, ``transform``
    and ``generator``, the last the port's ``decoder``) into the port's
    model of the same configuration, in place, and return it. Raises on any
    name or shape that does not match."""
    params = variables.get("params", variables)
    _copy_tree(module, {SONGSPLAT_CHILDREN.get(k, k): v for k, v in params.items()}, "")
    return module


def songsplat_to_flax(module: torch.nn.Module) -> dict:
    """The port's ``SongSplatModel`` as ``mptpu``'s flax variables
    ``{"params": tree}`` of float32 numpy, the inverse of
    :func:`songsplat_from_flax`."""
    back = {v: k for k, v in SONGSPLAT_CHILDREN.items()}
    return {"params": {back.get(k, k): v for k, v in _flax_tree(module).items()}}


def _flax_tree(module: torch.nn.Module) -> dict:
    """The flax parameter tree of ``module`` as float32 numpy, the inverse
    of ``_copy_tree``: an ``nn.Linear`` as a ``Dense`` (its weight
    transposed into the kernel), an ``nn.Conv1d`` as a ``Conv`` (weight
    (out, in, k) as kernel (k, in, out)), a parameter as an array, a child
    that holds parameters as a subtree."""
    out = {name: p.detach().cpu().numpy().copy()
           for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, torch.nn.Linear):
            out[name] = {"kernel": child.weight.detach().cpu().numpy().T.copy()}
            if child.bias is not None:
                out[name]["bias"] = child.bias.detach().cpu().numpy().copy()
        elif isinstance(child, torch.nn.Conv1d):
            out[name] = {"kernel": child.weight.detach().cpu().numpy().transpose(2, 1, 0).copy(),
                         "bias": child.bias.detach().cpu().numpy().copy()}
        else:
            sub = _flax_tree(child)
            if sub:
                out[name] = sub
    return out


def flax_paths(module: torch.nn.Module, prefix: tuple = ()) -> dict:
    """``{parameter name: its path in the flax tree}`` of ``module``, e.g.
    ``"to_event_switch.weight" -> ("to_event_switch", "kernel")``."""
    out = {name: prefix + (name,) for name, _ in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, (torch.nn.Linear, torch.nn.Conv1d)):
            for pname, _ in child.named_parameters(recurse=False):
                out[f"{name}.{pname}"] = prefix + (name, "kernel" if pname == "weight" else pname)
        else:
            out.update({f"{name}.{k}": v for k, v in flax_paths(child, prefix + (name,)).items()})
    return out


def _rnn_names(module: torch.nn.Module, tree):
    """``tree`` with every ``InstrumentModel``'s ``w_ih`` and ``w_hh`` (flax's
    (in, out) matrices) moved into ``{"rnn": {"weight_ih_l0",
    "weight_hh_l0"}}``, transposed, where the port's module holds an
    ``nn.RNN`` as ``rnn``."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _rnn_names(getattr(module, k), v) if isinstance(getattr(module, k, None),
                                                                torch.nn.Module) else v
           for k, v in tree.items()}
    if isinstance(getattr(module, "rnn", None), torch.nn.RNN) and {"w_ih", "w_hh"} <= set(out):
        out["rnn"] = {"weight_ih_l0": np.asarray(out.pop("w_ih")).T,
                      "weight_hh_l0": np.asarray(out.pop("w_hh")).T}
    return out


def ssm_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a flax tree of one of ``mptpu``'s SSM modules (``{"params":
    ...}`` or its ``"params"`` entry) into the port's module of the same
    configuration, in place, and return it: an ``OverfitControlPlane``'s
    (``control``; ``ssm``'s ``proj``, ``out_proj`` and the RNN's ``w_ih``
    and ``w_hh``, transposed into ``nn.RNN``'s weights), an
    ``InstrumentModel``'s, a ``CompressionModel``'s or a ``ComplexSSM``'s
    (complex leaves as complex64), an ``SSM``'s, or a
    ``StateSpaceModelEventGenerator``'s (its five hypernetworks' Dense
    layers). Raises on any name or shape that does not match."""
    _copy_tree(module, _rnn_names(module, variables.get("params", variables)), "")
    return module


def _batch_norms(module: torch.nn.Module) -> dict:
    """{flax path: BatchNorm} of every flax-form ``BatchNorm`` in ``module``."""
    from .nn.layers import BatchNorm

    return {tuple(name.split(".")) if name else (): m for name, m in module.named_modules()
            if isinstance(m, BatchNorm)}


def _flatten(tree, prefix: tuple = ()) -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def module_from_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy flax variables into the port's module of the same
    configuration, in place, and return it: ``variables["params"]`` (or
    ``variables`` itself when it has no ``"params"``) by name
    (a flax ``Dense`` into an ``nn.Linear``, its kernel transposed; a
    ``Conv`` into an ``nn.Conv1d``), and ``variables["batch_stats"]``
    (each ``BatchNorm``'s ``mean`` and ``var``) into the module's
    ``BatchNorm`` buffers, which must be exactly those the tree names.
    Serves every module family whose children carry flax's names: the
    ``nn`` stacks (``DilatedStack``, ``MixerStack``, ``Transformer``,
    ``MetaFormer``), ``UNet`` and ``DownsamplingDiscriminator``,
    ``ConvUpsample``, ``AntiCausalAnalysis`` with ``do_norm``,
    ``FuncSong``, ``AudioOperator``, ``TexturalModel``, ``RoomModel``,
    the multiresolution shells, ``NoiseModel``, ``GenerateMix``,
    ``GenerateImpulse``, the resonance modules (``ResonanceBank``,
    ``TimeVaryingMix``, ``ResonanceBlock`` with its one shared bank,
    ``ResonanceChain``: each bank's ``res_samples``, ``filters`` and
    ``Dense_0``), ``OverfitResonanceStack`` with its top-level ``latent``,
    and the three spectral info losses. Raises on any name or shape that
    does not match."""
    _copy_tree(module, variables.get("params", variables), "")
    stats = _flatten(variables.get("batch_stats", {}))
    norms = _batch_norms(module)
    want = {path + (leaf,) for path in norms for leaf in ("mean", "var")}
    if set(stats) != want:
        raise ValueError(f"batch_stats {sorted(stats)} against the module's BatchNorm buffers "
                         f"{sorted(want)}")
    with torch.no_grad():
        for path, arr in stats.items():
            buf = getattr(norms[path[:-1]], path[-1])
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape != tuple(buf.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} against "
                                 f"{tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(arr.copy()))
    return module


def module_to_flax(module: torch.nn.Module) -> dict:
    """The port's module as flax variables of float32 numpy, the inverse of
    :func:`module_from_flax`: ``{"params": tree}``, with ``"batch_stats"``
    where the module holds a ``BatchNorm``."""
    out = {"params": _flax_tree(module)}
    norms = _batch_norms(module)
    if norms:
        stats = {}
        for path, bn in norms.items():
            node = stats
            for k in path:
                node = node.setdefault(k, {})
            node.update(mean=bn.mean.detach().cpu().numpy().copy(),
                        var=bn.var.detach().cpu().numpy().copy())
        out["batch_stats"] = stats
    return out
