"""Top-k sparsification family (counterpart of ``mptpu/sparse/topk.py``),
batched: gathers and scatters over the whole batch at once.

``lax.top_k`` orders equal values by index, lower first, where
``torch.topk`` makes no promise. So the port takes the first k of a stable
descending sort, and for k = 1 ``torch.argmax``, whose first index is
``lax.top_k``'s on ties too (a dead attention of all zeros picks 0; a
range query over a 0/1 mask is all ties).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from ..ops import kinks
from ..ops.ste import soft_dirac, straight_through


class SparsifyResult(NamedTuple):
    sparse: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor


def _scatter(size: int, indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(batch, size) zeros with ``values`` set at ``indices``, row by row."""
    out = torch.zeros((indices.shape[0], size), dtype=values.dtype, device=values.device)
    return out.scatter(-1, indices, values)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    equal entries in index order (``lax.top_k``'s)."""
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return x.gather(-1, idx), idx
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def sparsify(
    x: torch.Tensor,
    n_to_keep: int,
    return_indices: bool = False,
    soft: bool = False,
    sharpen: bool = False,
    salience: torch.Tensor | None = None,
):
    """Keep the top-k entries across all non-batch dims, zero the rest.

    ``sharpen`` picks the peaks of ``x`` less its (9, 27) average pool over
    (channel, time), the values still from ``x``; ``salience`` picks by it
    and scales the result by it; ``soft`` gives the backward pass the dense
    input rescaled to the sparse output's norm (straight-through).
    """
    orig = x
    batch = x.shape[0]
    orig_shape = x.shape
    flat = x.reshape(batch, -1)
    if sharpen:
        xs = x.reshape(-1, 1, x.shape[1], x.shape[-1])
        pooled = F.avg_pool2d(xs, (9, 27), stride=1, padding=(4, 13), count_include_pad=True)
        sharpened = (xs - pooled).reshape(batch, -1)
    elif salience is not None:
        sharpened = salience.reshape(batch, -1)
    else:
        sharpened = flat

    _, indices = _top_k(sharpened, n_to_keep)
    values = flat.gather(-1, indices)
    out = _scatter(flat.shape[-1], indices, values).reshape(orig_shape)

    if salience is not None:
        out = out * salience.reshape(orig_shape)

    if soft:
        norm_shape = (batch,) + (1,) * (x.ndim - 1)
        b_norm = torch.linalg.vector_norm(orig.reshape(batch, -1), dim=-1).reshape(norm_shape)
        f_norm = torch.linalg.vector_norm(out.reshape(batch, -1), dim=-1).reshape(norm_shape)
        out = straight_through(out, orig / (b_norm + 1e-12) * f_norm)

    if return_indices:
        return out, indices, values
    return out


def sparsify2(x: torch.Tensor, n_to_keep: int = 8):
    """Top-k over (channels x time), returning (sparse, packed, one_hot):

    sparse:  (batch, channels, time), the input with all but k zeroed;
    packed:  (batch, n_to_keep, time), event k's value at its time;
    one_hot: (batch, n_to_keep, channels), event k's value at its channel.
    """
    batch, channels, time = x.shape
    values, indices = _top_k(x.reshape(batch, -1), n_to_keep)
    ch, t = indices // time, indices % time
    k_range = torch.arange(n_to_keep, device=x.device)
    sparse = _scatter(channels * time, indices, values).reshape(batch, channels, time)
    context = _scatter(n_to_keep * channels, k_range * channels + ch, values)
    packed = _scatter(n_to_keep * time, k_range * time + t, values)
    return (
        sparse,
        packed.reshape(batch, n_to_keep, time),
        context.reshape(batch, n_to_keep, channels),
    )


def sparsify_vectors(
    x: torch.Tensor,
    attn: torch.Tensor,
    n_to_keep: int,
    normalize: bool = True,
    dense: bool = False,
):
    """The channel vectors of the k time steps of highest attention.

    x: (batch, channels, time); attn: (batch, time) or anything of that
    size. Returns (latents (batch, k, channels), indices (batch, k)), or
    with ``dense`` the latents put back at their times in zeros like ``x``.
    """
    batch, channels, time = x.shape
    values, indices = _top_k(attn.reshape(batch, time), n_to_keep)
    if normalize:
        # kept literal: 1 with zero gradient, but exactly 0 in float32 where
        # values reach ~1e9, so that a blown-up switch zeroes its own vector
        values = values + (1 - values)
    gathered = x.gather(-1, indices[:, None, :].expand(batch, channels, n_to_keep))
    latents = gathered.transpose(1, 2) * values[..., None]   # (batch, k, channels)
    if dense:
        idx = indices[:, None, :].expand(batch, channels, n_to_keep)
        return torch.zeros_like(x).scatter(-1, idx, latents.transpose(1, 2))
    return latents, indices


def encourage_sparsity_loss(
    encoding: torch.Tensor,
    n_unpenalized: int = 128,
    sparsity_loss_weight: float = 0.00001,
) -> torch.Tensor:
    """L1 penalty on everything past the top ``n_unpenalized`` activations."""
    flat = encoding.reshape(encoding.shape[0], -1)
    srt = torch.sort(flat, dim=-1, descending=True).values
    return kinks.abs(srt[:, n_unpenalized:]).sum() * sparsity_loss_weight


def to_key_points(x: torch.Tensor, n_to_keep: int = 64) -> torch.Tensor:
    """(batch, width, height) -> (batch, n_to_keep, 3) key points of
    (value, width location, height location), the locations soft-dirac
    readings of the spans through each top-k entry. The index arithmetic
    is ``mptpu``'s as written (``indices % width``, ``indices // height``)."""
    batch, width, height = x.shape
    values, indices = _top_k(x.reshape(batch, -1), n_to_keep)
    row_index = indices % width
    col_index = indices // height
    w_range = torch.linspace(0, 1, width, dtype=x.dtype, device=x.device)
    h_range = torch.linspace(0, 1, height, dtype=x.dtype, device=x.device)

    col_idx = torch.clamp(col_index, 0, height - 1)
    width_span = x.gather(2, col_idx[:, None, :].expand(batch, width, n_to_keep))
    width_span = soft_dirac(width_span.transpose(1, 2), axis=-1)   # (batch, k, width)
    row_idx = torch.clamp(row_index, 0, width - 1)
    height_span = x.gather(1, row_idx[:, :, None].expand(batch, n_to_keep, height))
    height_span = soft_dirac(height_span, axis=-1)                 # (batch, k, height)

    return torch.stack([values, width_span @ w_range, height_span @ h_range], dim=-1)


class ElementwiseSparsity(nn.Module):
    """Expand -> top-k -> contract. ``Dense_0`` and ``Dense_1`` keep the
    flax module's parameter names, so that ``mptpu_torch.convert.
    module_from_flax`` copies its parameters by name."""

    def __init__(self, model_dim: int, high_dim: int = 2048, keep: int = 64,
                 use_softmax: bool = False, device=None):
        super().__init__()
        dev = default_device(device)
        self.keep = keep
        self.use_softmax = use_softmax
        self.Dense_0 = nn.Linear(model_dim, high_dim, device=dev)
        self.Dense_1 = nn.Linear(high_dim, model_dim, device=dev)

    def forward(self, x: torch.Tensor):   # (batch, model_dim, time)
        h = self.Dense_0(x.transpose(1, 2)).transpose(1, 2)
        if self.use_softmax:
            h = torch.softmax(h, dim=1)
        sparse = sparsify(h, self.keep)
        out = self.Dense_1(sparse.transpose(1, 2))
        return out.transpose(1, 2), sparse


class VectorwiseSparsity(nn.Module):
    """Learned attention -> the top-k time steps' vectors (``Dense_0`` as
    in the flax module)."""

    def __init__(self, model_dim: int, keep: int = 16, channels_last: bool = True,
                 normalize: bool = False, device=None):
        super().__init__()
        self.keep = keep
        self.channels_last = channels_last
        self.normalize = normalize
        self.Dense_0 = nn.Linear(model_dim, 1, device=default_device(device))

    def forward(self, x: torch.Tensor):
        if self.channels_last:
            x = x.transpose(1, 2)   # -> (batch, channels, time)
        batch, channels, time = x.shape
        attn = self.Dense_0(x.transpose(1, 2)).reshape(batch, time)
        return sparsify_vectors(x, attn, n_to_keep=self.keep, normalize=self.normalize)
