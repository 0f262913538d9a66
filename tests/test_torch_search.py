"""Event search and event-set embeddings (``mptpu/models/search.py``,
``mptpu/models/pointcloud.py``, ``scripts/build_index.py``, and
``mptpu/data/datastore.py:iter_files_in_random_order, iter_audio_segments``)
in the port against ``mptpu`` on JAX-CPU: ``k_nearest`` and
``CanonicalOrdering`` on ties, the pairwise differences and their upper
triangle, ``GraphEdgeEmbedding``, ``BruteForceSearch`` (its QR
projection from the same normal draw), ``build_index``, the segments of
the demo corpus under a temporary ``MPTPU_CACHE``, the script's embedder
at a chunk of 2,048 samples with ``mptpu``'s dictionaries and projection
carried across, the index flow, and a rehearsal of ``chip_smoke.py``'s
phase 10 at small sizes.

Tolerances: indices, keys, orders and chunks identical; embeddings of
the same events rtol 1e-5 and an atol of 1e-6 of their largest (float32
sums in other orders); the QR projection within 1e-6 (measured 6e-8,
LAPACK's signs the same in both packages).
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.data import datastore as jds
from mptpu.models import pointcloud as jpc
from mptpu.models import search as jsearch
from mptpu.sparse import BandSpec as JBandSpec
from mptpu.sparse import MultibandDictionaryLearning as JMultiband
from mptpu_torch import convert
from mptpu_torch.data import datastore as tds
from mptpu_torch.data.kv import KVCollection
from mptpu_torch.models import pointcloud as tpc
from mptpu_torch.models import search as tsearch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work (the suite may run in
    six test processes on one machine)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """MPTPU_CACHE under ``tmp_path`` for both packages (``mptpu``'s
    collection is a module global, reset here), no AUDIO_PATH, and the
    working directory ``tmp_path``."""
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.setattr(jds, "_collection", None)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- k_nearest and the canonical ordering on ties ----------------------------------------------

def test_k_nearest_keeps_index_order_on_ties():
    """200 embeddings at three distances from the query (copies of three
    points): the nearest come lowest index first, as jnp.argsort's stable
    sort gives; PyTorch's default argsort puts index 125 first on such a
    tie."""
    points = normal((3, 8), 1)
    emb = points[np.arange(200) % 3] * np.float32(1.0)
    query = points[1] + np.float32(0.01)
    want = np.asarray(jsearch.k_nearest(jnp.asarray(query), jnp.asarray(emb), 70))
    got = tsearch.k_nearest(torch.from_numpy(query), torch.from_numpy(emb), 70)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist()[:3] == [1, 4, 7]


def test_canonical_ordering_on_ties_and_its_projection():
    """64 points of which many project equally (repeated rows), mptpu's
    projection carried in: the same order, ties in their first order."""
    x = normal((2, 4, 3), 2)[:, np.arange(64) % 4, :]
    order = jpc.CanonicalOrdering(3)
    want = np.asarray(order(jnp.asarray(x)))
    got = tpc.CanonicalOrdering(3, transform=np.asarray(order.projection), device="cpu")(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    own = tpc.CanonicalOrdering(3, seed=0, device="cpu")
    assert own.projection.shape == (3, 1) and float(own.projection.abs().max()) <= 1.0


def test_pairwise_differences_and_upper_triangle():
    x = normal((2, 5, 4), 3)
    want = jpc.flattened_upper_triangular(jpc.pairwise_differences(jnp.asarray(x)))
    got = tpc.flattened_upper_triangular(tpc.pairwise_differences(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_graph_edge_embedding():
    """mptpu's projections carried in: the embedding within 1e-6, unit
    norm, and invariant to the order of the points."""
    jg = jpc.GraphEdgeEmbedding(n_items=5, embedding_dim=4, out_channels=8)
    tg = tpc.GraphEdgeEmbedding(5, 4, 8, ordering_transform=np.asarray(jg.ordering.projection),
                                projection=np.asarray(jg.projection), device="cpu")
    x = normal((2, 5, 4), 4)
    want = np.asarray(jg(jnp.asarray(x)))
    got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tg(torch.from_numpy(x[:, ::-1].copy())).numpy(), got, atol=1e-6)
    with pytest.raises(ValueError, match="projection"):
        tpc.GraphEdgeEmbedding(5, 4, 8, projection=np.zeros((3, 8)), device="cpu")


# ---- BruteForceSearch and build_index ----------------------------------------------------------

def test_brute_force_search():
    """Results, keys and the 2-d view from mptpu's normal draw: the QR
    projection within 1e-6, the same signs."""
    emb = normal((20, 8), 5)
    keys = [f"k{i}" for i in range(20)]
    js = jsearch.BruteForceSearch(jnp.asarray(emb), keys, n_results=3)
    gaussian = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 2)))
    ts = tsearch.BruteForceSearch(emb, keys, n_results=3, gaussian=gaussian, device="cpu")
    np.testing.assert_allclose(ts.projection.numpy(), np.asarray(js.projection), atol=1e-6)
    np.testing.assert_allclose(ts.visualization().numpy(), np.asarray(js.visualization()),
                               rtol=1e-5, atol=1e-6)
    found, vecs = ts.search(torch.from_numpy(emb[7]))
    want_keys, want_vecs = js.search(jnp.asarray(emb[7]))
    assert found == want_keys and found[0] == "k7" and len(found) == 3
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(want_vecs))
    for seed in (0, 3):
        key, vec = ts.choose_random(seed)
        assert (key, vec.tolist()) == (lambda kv: (kv[0], np.asarray(kv[1]).tolist()))(
            js.choose_random(seed))
    own = tsearch.BruteForceSearch(emb, keys, device="cpu")
    np.testing.assert_allclose(own.projection.T @ own.projection, np.eye(2), atol=1e-6)


def test_build_index():
    """The first max_items chunks' keys and float32 embeddings; no segment
    gives mptpu's (keys, (keys, None))."""
    segs = [(f"c{i}", np.full((1, 1, 4), i, np.float32)) for i in range(5)]

    def embed(chunk):
        return np.concatenate([chunk.reshape(-1), chunk.reshape(-1) ** 2])

    jk, je = jsearch.build_index(iter(segs), embed, max_items=3)
    tk, te = tsearch.build_index(iter(segs), embed, max_items=3, device="cpu")
    assert tk == jk and te.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    empty = jsearch.build_index(iter([]), embed)
    assert tsearch.build_index(iter([]), embed, device="cpu") == empty


# ---- the corpus, the script's embedder and the index flow -------------------------------------

def test_files_and_segments_in_mptpus_order(cache, monkeypatch):
    """iter_files_in_random_order under one generator, and iter_audio_segments
    with numpy's fresh generator fixed for both packages: the same files,
    keys and chunks, bit for bit."""
    rng = np.random.default_rng
    want = list(jds.iter_files_in_random_order(jds._resolve_path(None), "*.wav", rng(4)))
    got = list(tds.iter_files_in_random_order(tds._resolve_path(None), "*.wav", rng(4)))
    assert got == want and len(got) == 4
    with monkeypatch.context() as m:
        m.setattr(np.random, "default_rng", lambda seed=None: rng(9 if seed is None else seed))
        want = list(jds.iter_audio_segments(None, "*.wav", 16384))
        got = list(tds.iter_audio_segments(None, "*.wav", 16384))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) > 32
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeded = list(tds.iter_audio_segments(None, "*.wav", 16384, rng=rng(9)))
    assert [k for k, _ in seeded] == [k for k, _ in got]


def load_script():
    """scripts/build_index.py as a module (its entry point stays under the
    __main__ check)."""
    spec = importlib.util.spec_from_file_location("build_index",
                                                  ROOT / "scripts" / "build_index.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHUNK = 2048


def carried_embedder():
    """The port's embedder at a chunk of 2,048 with the script's
    dictionaries (BandSpec draws them from PRNGKey(size)) and projection
    (PRNGKey(1)'s normal draw)."""
    specs = [JBandSpec(size, n_atoms=64, atom_size=128, signal_samples=CHUNK,
                       is_lowest_band=(size == 512)) for size in (512, 1024, 2048)]
    jm = JMultiband(specs, CHUNK)
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (jm.total_atoms + 2, 256)))
    return tsearch.make_embedder(CHUNK, dicts=convert.band_dicts_from_jax(jm, device="cpu"),
                                 projection=draw, device="cpu")


def test_make_embedder_against_the_script(cache):
    """The script's make_embedder and the port's on three chunks of the demo
    corpus: the same events, so embeddings within rtol 1e-5 and 1e-6 of
    their largest."""
    j_embed = load_script().make_embedder(CHUNK)
    t_embed = carried_embedder()
    assert len(t_embed.model.bands) == 3 and t_embed.projection.shape == (194, 256)
    chunks = [c for _, (_, c) in zip(range(3), tds.iter_audio_segments(
        None, "*.wav", CHUNK, rng=np.random.default_rng(1)))]
    for chunk in chunks:
        want = j_embed(chunk)
        got = t_embed(chunk)
        assert got.dtype == want.dtype and got.shape == (256,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    own = tsearch.make_embedder(CHUNK, device="cpu")
    assert own(chunks[0]).shape == (256,)


def test_index_corpus_writes_the_index_and_finds_its_query(cache):
    """build_index.py's main at 6 chunks of 2,048 through the port: the
    index under the relative default path, keys and embeddings read back,
    the query's own chunk first."""
    lines = []
    out = tsearch.index_corpus(chunks=6, chunk_size=CHUNK, embed=carried_embedder(),
                               rng=np.random.default_rng(2), device="cpu", log=lines.append)
    assert len(out.keys) == 6 and out.embeddings.shape == (6, 256)
    kv = KVCollection(str(cache / "trained_weights" / "search_index"))
    assert kv.get("keys").decode().split("\n") == out.keys
    np.testing.assert_array_equal(kv.get("embeddings"), out.embeddings.numpy())
    assert out.result_keys[0] == out.query_key and len(out.result_keys) == 4
    assert lines[0] == "indexed 6 chunks" and lines[1] == f"query: {out.query_key}"


def test_chip_smoke_models_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 10 at small sizes on the CPU (its own temporary
    MPTPU_CACHE and output directories): the song splat trainer, the
    instrument, the index and the learned-atom MP, the CPU against itself,
    no kernel launched."""
    import chip_smoke

    chip_smoke.models_phase(torch.device("cpu"), chip_smoke.MODELS_SMALL, lambda: None)
