"""Event-set embeddings: a canonical ordering of the points, then an
embedding of their pairwise differences (counterpart of
``mptpu/models/pointcloud.py``).

``mptpu`` draws its projections from ``PRNGKey(seed)`` and ``PRNGKey(seed
+ 1)``; the port draws them from CPU ``torch.Generator``s seeded alike
(other numbers), or takes them as given, which is how the tests carry
``mptpu``'s across.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device
from ..ops.norms import unit_norm


def pairwise_differences(features: torch.Tensor) -> torch.Tensor:
    """(batch, n_points, dim) -> (batch, dim, n_points, n_points), entry
    [b, :, i, j] = features[b, j] - features[b, i]."""
    diff = features[:, None, :, :] - features[:, :, None, :]
    return diff.permute(0, 3, 1, 2)


def flattened_upper_triangular(x: torch.Tensor) -> torch.Tensor:
    """(batch, dim, a, a) -> (batch, dim, a (a - 1) / 2): the entries above
    the diagonal in row-major order (``np.triu_indices(a, k=1)``'s)."""
    a = x.shape[2]
    rows, cols = torch.triu_indices(a, a, offset=1, device=x.device)
    return x[:, :, rows, cols]


class CanonicalOrdering:
    """Order the points of each set by a fixed 1-d projection, ascending;
    equal projections keep their order (``jnp.argsort`` is stable). The
    projection is ``transform`` ((embedding_dim,) or (embedding_dim, 1)),
    else uniform in [-1, 1) from a generator seeded with ``seed``."""

    def __init__(self, embedding_dim: int, transform=None, seed: int = 0, device=None):
        dev = default_device(device)
        self.embedding_dim = embedding_dim
        if transform is None:
            gen = torch.Generator().manual_seed(seed)
            transform = torch.rand((embedding_dim, 1), generator=gen) * 2.0 - 1.0
        self.projection = torch.as_tensor(np.array(transform, np.float32)).reshape(
            embedding_dim, 1).to(dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        z = x @ self.projection   # (batch, n_points, 1)
        indices = torch.argsort(z, dim=1, stable=True)
        return torch.take_along_dim(x, indices, dim=1)


class GraphEdgeEmbedding:
    """Canonical order, pairwise differences, their upper triangle
    flattened, a random projection to ``out_channels``, unit-normed. The
    projection is ``projection`` ((edges x embedding_dim, out_channels)),
    else a normal draw from a generator seeded with ``seed + 1`` over the
    root of its rows; ``ordering_transform`` goes to the ordering."""

    def __init__(self, n_items: int, embedding_dim: int, out_channels: int, seed: int = 0,
                 ordering_transform=None, projection=None, device=None):
        dev = default_device(device)
        self.ordering = CanonicalOrdering(embedding_dim, ordering_transform, seed=seed, device=dev)
        self.embedding_dim = embedding_dim
        self.out_channels = out_channels
        self.upper_triangular = n_items * (n_items - 1) // 2
        self.total_edge_dim = self.upper_triangular * embedding_dim
        if projection is None:
            gen = torch.Generator().manual_seed(seed + 1)
            projection = (torch.randn((self.total_edge_dim, out_channels), generator=gen)
                          / np.sqrt(self.total_edge_dim))
        self.projection = torch.as_tensor(np.array(projection, np.float32)).to(dev)
        if self.projection.shape != (self.total_edge_dim, out_channels):
            raise ValueError(f"projection {tuple(self.projection.shape)}, expected "
                             f"{(self.total_edge_dim, out_channels)}")

    def __call__(self, embeddings: torch.Tensor) -> torch.Tensor:
        batch = embeddings.shape[0]
        diff = pairwise_differences(self.ordering(embeddings))
        edges = flattened_upper_triangular(diff).reshape(batch, self.total_edge_dim)
        return unit_norm(edges @ self.projection)
