"""Brute-force nearest-neighbour search over event embeddings, the index
flow, and ``scripts/build_index.py``'s embedder and run (counterpart of
``mptpu/models/search.py`` and ``scripts/build_index.py``).

The embedder codes each chunk with the multiband matching pursuit, whose
encode runs the cluster step kernel on a card (``sparse/multiband.py``),
sums each atom's amplitudes into a feature per atom, appends the mean
time and amplitude, and projects the whole at random. Its arithmetic
after the encode is ``mptpu``'s numpy, the same floats for the same
events and projection.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.datastore import iter_audio_segments
from ..data.kv import KVCollection
from ..device import default_device
from ..sparse.multiband import BandSpec, MultibandDictionaryLearning


def k_nearest(query: torch.Tensor, embeddings: torch.Tensor, n_results: int = 16) -> torch.Tensor:
    """Indices of the ``n_results`` embeddings nearest ``query`` in L2
    distance, equal distances in index order (``jnp.argsort`` is stable)."""
    dim = embeddings.shape[-1]
    dist = torch.linalg.vector_norm(embeddings - query.reshape(1, dim), dim=-1)
    return torch.argsort(dist, stable=True)[:n_results]


class BruteForceSearch:
    """k-NN over ``embeddings`` (n_items, dim), each named by ``keys``. The
    2-d view projects through Q of the QR factorisation of a (dim,
    visualization_dim) normal draw: ``gaussian`` when given, else drawn from
    a generator seeded with ``seed``."""

    def __init__(self, embeddings, keys: List[str], n_results: int = 16,
                 visualization_dim: int = 2, seed: int = 0, gaussian=None, device=None):
        dev = default_device(device)
        self.embeddings = torch.as_tensor(embeddings).to(dev)
        self.keys = keys
        self.n_results = n_results
        self.visualization_dim = visualization_dim
        if gaussian is None:
            gaussian = torch.randn((self.embeddings.shape[-1], visualization_dim),
                                   generator=torch.Generator().manual_seed(seed))
        q, _ = torch.linalg.qr(torch.as_tensor(np.array(gaussian, np.float32)))
        self.projection = q[:, :visualization_dim].to(dev)

    def __len__(self):
        return len(self.keys)

    def choose_random(self, seed: int | None = None) -> Tuple[str, torch.Tensor]:
        index = int(np.random.default_rng(seed).integers(len(self)))
        return self.keys[index], self.embeddings[index]

    def visualization(self) -> torch.Tensor:
        return self.embeddings @ self.projection

    def search(self, query: torch.Tensor):
        """(keys, embeddings) of the nearest ``n_results``, nearest first."""
        indices = k_nearest(query, self.embeddings, self.n_results)
        return [self.keys[i] for i in indices.tolist()], self.embeddings[indices]


def build_index(segments: Iterable[Tuple[str, np.ndarray]], compute_embedding,
                max_items: int | None = None, device=None):
    """(keys, embeddings (n, dim) float32 on ``device``) of the first
    ``max_items`` (key, chunk) pairs, ``compute_embedding(chunk) -> (dim,)``.
    With no segment the second entry is ``(keys, None)``, as ``mptpu``'s
    operator precedence makes it."""
    keys, embs = [], []
    for i, (key, chunk) in enumerate(segments):
        if max_items is not None and i >= max_items:
            break
        keys.append(key)
        embs.append(np.asarray(compute_embedding(chunk)).reshape(-1))
    if not embs:
        return keys, (keys, None)
    return keys, torch.from_numpy(np.stack(embs).astype(np.float32)).to(default_device(device))


BAND_SIZES = (512, 1024, 2048, 4096, 8192, 16384)


class EventEmbedder:
    """``scripts/build_index.py:make_embedder``'s embedding of a chunk
    (1, 1, n_samples): the multiband encode (``steps`` events a band), the
    amplitudes summed per global atom, the mean unit time and mean
    amplitude, times ``projection`` ((total_atoms + 2, dim))."""

    def __init__(self, model: MultibandDictionaryLearning, projection: np.ndarray,
                 steps: int):
        self.model = model
        self.projection = projection
        self.steps = steps
        self.device = next(iter(model.bands.values())).device

    def __call__(self, chunk) -> np.ndarray:
        model = self.model
        x = torch.as_tensor(np.asarray(chunk, np.float32)).to(self.device)
        gi, ut, amp = model.flattened_event_tuples(model.encode(x, self.steps))
        feats = np.zeros(model.total_atoms + 2, dtype=np.float32)
        np.add.at(feats, gi.cpu().numpy(), amp.cpu().numpy())
        feats[-2] = float(torch.mean(ut))
        feats[-1] = float(torch.mean(amp))
        return feats @ self.projection


def make_embedder(n_samples: int, dim: int = 256, steps: int = 8, dicts: Optional[dict] = None,
                  projection=None, device=None) -> EventEmbedder:
    """The script's embedder: bands of 512 to 16,384 samples (those not
    above ``n_samples``), 64 atoms x 128 taps each, ``steps`` events a band.
    The dictionaries are ``dicts`` ({size: (64, 128)}, e.g.
    ``convert.band_dicts_from_jax`` of ``mptpu``'s model) or the bands' own
    seeded draws; the projection's normal draw is ``projection`` ((total
    atoms + 2, dim), ``mptpu``'s ``PRNGKey(1)`` draw) or one from a
    generator seeded with 1, over the root of the atom count."""
    dev = default_device(device)
    specs = [BandSpec(size, n_atoms=64, atom_size=128, signal_samples=n_samples,
                      is_lowest_band=(size == 512), device=dev,
                      d=None if dicts is None else dicts[size])
             for size in BAND_SIZES if size <= n_samples]
    model = MultibandDictionaryLearning(specs, n_samples)
    if projection is None:
        projection = torch.randn((model.total_atoms + 2, dim),
                                 generator=torch.Generator().manual_seed(1)).numpy()
    projection = np.asarray(projection, np.float32) / np.sqrt(model.total_atoms)
    return EventEmbedder(model, projection, steps)


class IndexedCorpus(NamedTuple):
    keys: List[str]
    embeddings: torch.Tensor    # (n_chunks, dim)
    query_key: Optional[str]    # the chunk queried, None without a query
    result_keys: List[str]      # its nearest chunks, nearest first


def index_corpus(chunks: int = 32, chunk_size: int = 16384, audio_path: Optional[str] = None,
                 query: bool = True, index_path: str = "trained_weights/search_index",
                 embed: Optional[Callable] = None, rng: Optional[np.random.Generator] = None,
                 device=None, log: Callable[[str], None] = print) -> IndexedCorpus:
    """``scripts/build_index.py:main``: embed the first ``chunks`` chunks of
    ``iter_audio_segments(audio_path, "*.wav", chunk_size, rng=rng)`` (the
    demo corpus without an audio path) with ``embed`` (default
    ``make_embedder(chunk_size)``), store the keys and embeddings in the
    ``KVCollection`` at ``index_path``, and, with ``query``, search for a
    chunk picked by ``choose_random(seed=0)`` among 4 results."""
    dev = default_device(device)
    embed = embed or make_embedder(chunk_size, device=dev)
    segments = iter_audio_segments(audio_path, "*.wav", chunk_size, rng=rng)
    keys, embeddings = build_index(segments, embed, max_items=chunks, device=dev)
    log(f"indexed {len(keys)} chunks")

    kv = KVCollection(index_path)
    kv.put("keys", "\n".join(keys).encode())
    kv.put("embeddings", embeddings.cpu().numpy())

    query_key, result_keys = None, []
    if query:
        search = BruteForceSearch(embeddings, keys, n_results=4, device=dev)
        query_key, qemb = search.choose_random(seed=0)
        result_keys, _ = search.search(qemb)
        log(f"query: {query_key}")
        for k in result_keys:
            log(f"  -> {k}")
    return IndexedCorpus(keys, embeddings, query_key, result_keys)
