"""The audio data layer of the port against ``mptpu``'s, on a corpus under
a temporary ``MPTPU_CACHE`` (``tmp_path``): WAV writing and resampling,
the synthetic demo corpus, the ``.env`` paths, the sqlite KV store and
``cache``, file discovery, the memoised decode (a second read is a hit in
the KV store), ``batch_stream``, ``iter_chunks``, the iterators and
``get_one_audio_segment``, and the HTML article.

Tolerance: none. Both packages draw from numpy with the same seed over the
same files, so files, samples and batches are compared bit for bit.
"""

import os

import numpy as np
import jax  # noqa: F401  (tests/conftest.py keeps JAX on the CPU)
import pytest
import torch

from mptpu.config import dotenv as jdotenv
from mptpu.data import audioiter as jai
from mptpu.data import datastore as jds
from mptpu.data import kv as jkv
from mptpu.data import synthetic as jsyn
from mptpu.obs import article as jart
from mptpu.obs.collection import encode_audio as j_encode_audio
from mptpu.utils import wav as jwav
from mptpu_torch import config as tconfig
from mptpu_torch.data import audioiter as tai
from mptpu_torch.data import datastore as tds
from mptpu_torch.data import kv as tkv
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.obs import article as tart
from mptpu_torch.obs import encode_audio as t_encode_audio
from mptpu_torch.utils import wav as twav


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """MPTPU_CACHE at ``tmp_path / "cache"`` for both packages (``mptpu``
    keeps its collection in a module global, reset here), no AUDIO_PATH,
    and a working directory without a ``.env``."""
    path = tmp_path / "cache"
    monkeypatch.setenv("MPTPU_CACHE", str(path))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.setattr(jds, "_collection", None)
    monkeypatch.chdir(tmp_path)
    return path


def small_corpus(directory, seconds=0.5, n_files=3):
    """A corpus of short files: a dense one, a sparse one at 11,025 Hz
    (resampled on decode) and one shorter than twice a window (padded)."""
    os.makedirs(directory, exist_ok=True)
    twav.write_wav(str(directory / "dense.wav"),
                   tsyn.synthetic_audio(int(seconds * 22050), n_events=8, seed=1,
                                        sustained=True))
    twav.write_wav(str(directory / "low.wav"),
                   tsyn.synthetic_audio(int(seconds * 11025), 11025, n_events=4, seed=2), 11025)
    twav.write_wav(str(directory / "short.wav"), tsyn.synthetic_audio(3000, n_events=2, seed=3))
    (directory / "notes.txt").write_text("not audio")
    return directory


# WAV files and the demo corpus ---------------------------------------------------------------

def test_write_wav_and_fft_resample_match(tmp_path):
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 1001).astype(np.float32)
    jwav.write_wav(str(tmp_path / "j.wav"), x, 16000)
    twav.write_wav(str(tmp_path / "t.wav"), x, 16000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    back, sr = twav.read_wav(str(tmp_path / "t.wav"))
    assert sr == 16000 and np.abs(back - np.clip(x, -1, 1)).max() < 1 / 16384
    for sr_in, sr_out in ((11025, 22050), (44100, 22050), (22050, 22050)):
        got = twav.fft_resample_np(x, sr_in, sr_out)
        want = jwav.fft_resample_np(x, sr_in, sr_out)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dense", [False, True])
def test_ensure_demo_dataset_writes_mptpus_files(tmp_path, dense):
    """The same files, byte for byte; a directory of the other kind is
    rewritten, of the same kind left alone."""
    kw = dict(n_files=2, seconds=0.25, dense=dense, seed_offset=7)
    jsyn.ensure_demo_dataset(str(tmp_path / "j"), **kw)
    assert tsyn.ensure_demo_dataset(str(tmp_path / "t"), **kw) == str(tmp_path / "t")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == (tmp_path / "t" / n).read_bytes()
    stamp = {n: os.stat(tmp_path / "t" / n).st_mtime_ns for n in names}
    tsyn.ensure_demo_dataset(str(tmp_path / "t"), **kw)
    assert {n: os.stat(tmp_path / "t" / n).st_mtime_ns for n in names} == stamp
    tsyn.ensure_demo_dataset(str(tmp_path / "t"), **dict(kw, dense=not dense))
    other = sorted(os.listdir(tmp_path / "t"))
    assert other != names and len(other) == 2


def test_config_paths(tmp_path, monkeypatch):
    """AUDIO_PATH and MPTPU_CACHE from the environment, else from .env, as
    ``mptpu``'s ``Config``; the cache directory is created, ``~/.mptpu_cache``
    by default."""
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.delenv("MPTPU_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    assert tconfig.audio_path() is None
    assert tconfig.cache_path() == str(tmp_path / "home" / ".mptpu_cache")
    assert os.path.isdir(tmp_path / "home" / ".mptpu_cache")
    (tmp_path / ".env").write_text(f"AUDIO_PATH={tmp_path}/a\nMPTPU_CACHE = {tmp_path}/c\n")
    assert tconfig.audio_path() == f"{tmp_path}/a"
    assert tconfig.cache_path() == f"{tmp_path}/c" and os.path.isdir(tmp_path / "c")
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "env"))
    monkeypatch.setenv("AUDIO_PATH", "/corpus")
    assert tconfig.cache_path() == str(tmp_path / "env") == jdotenv.Config.cache_path()
    assert tconfig.audio_path() == "/corpus" == jdotenv.Config.audio_path()


# the KV store --------------------------------------------------------------------------------

def test_kv_collection_and_cache_read_across_packages(tmp_path):
    coll = tkv.KVCollection(str(tmp_path / "kv"))
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    coll.put("a:1", arr)
    coll["a:2"] = b"raw"
    coll.put("b:1", {"x": [1, 2]})
    assert np.array_equal(coll["a:1"], arr) and coll.get("a:2") == b"raw"
    assert coll.get("b:1") == {"x": [1, 2]} and "a:1" in coll and "c" not in coll
    assert list(coll.keys("a:")) == ["a:1", "a:2"]
    assert [k for k, _ in coll.iter_prefix("")] == ["a:1", "a:2", "b:1"]
    coll.delete("a:2")
    with pytest.raises(KeyError):
        coll.get("a:2")
    other = jkv.KVCollection(str(tmp_path / "kv.db"))     # mptpu reads the port's file
    assert np.array_equal(other.get("a:1"), arr) and other.get("b:1") == {"x": [1, 2]}
    calls = []

    @tkv.cache(coll)
    def square(x):
        calls.append(x)
        return np.full(2, x * x, np.float32)

    assert np.array_equal(square(3), [9, 9]) and np.array_equal(square(3), [9, 9])
    assert calls == [3] and square.__name__ == "square"
    assert tkv.hash_function(square, 3) == jkv.hash_function(square, 3)


# file discovery, decode, streams -------------------------------------------------------------

def test_iter_files_and_memoised_decode(cache, tmp_path, monkeypatch):
    """The same files in the same order; a decode equal to ``mptpu``'s
    (resampled from 11,025 Hz), stored under ``mptpu``'s key; the second read
    comes from the KV store without decoding."""
    corpus = small_corpus(tmp_path / "corpus")
    for pattern in ("*.wav", ["*dense*", "*.txt"]):
        assert list(tds.iter_files(corpus, pattern)) == list(jds.iter_files(corpus, pattern))
    path = str(corpus / "low.wav")
    got = tds.audio(path)
    assert got.dtype == np.float32 and np.array_equal(got, jds.audio(path))
    assert len(got) == 2 * int(0.5 * 11025)
    coll = tds.audio_collection()
    assert f"audio:{path}:22050" in coll

    def no_decode(*a, **k):
        raise AssertionError("decoded again: the KV store missed")

    monkeypatch.setattr(tds, "_decode", no_decode)
    assert np.array_equal(tds.audio(path), got)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, n_samples=2048, seed=4),
    dict(batch_size=2, n_samples=1024, seed=5, normalize=True, step_size=64, return_indices=True),
    dict(batch_size=4, n_samples=4096, seed=6, overfit=True, normalize=True),
])
def test_batch_stream_is_mptpus_bit_for_bit(cache, tmp_path, kw):
    corpus = str(small_corpus(tmp_path / "corpus"))
    args = (corpus, "*.wav", kw.pop("batch_size"), kw.pop("n_samples"))
    got, want = tds.batch_stream(*args, **kw), jds.batch_stream(*args, **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        if kw.get("return_indices"):
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_batch_stream_refuses_an_empty_match(cache, tmp_path):
    corpus = str(small_corpus(tmp_path / "corpus"))
    with pytest.raises(FileNotFoundError):
        next(tds.batch_stream(corpus, "*.flac", 1, 512))


def test_iter_chunks(cache, tmp_path):
    corpus = str(small_corpus(tmp_path / "corpus"))
    assert list(tds.iter_chunks(corpus, "*.wav", 2048)) == list(
        jds.iter_chunks(corpus, "*.wav", 2048))


def test_iterators_yield_mptpus_batches_as_tensors(cache, tmp_path):
    corpus = str(small_corpus(tmp_path / "corpus"))
    kw = dict(normalize=True, step_size=32, audio_path=corpus, seed=8)
    got = iter(tai.AudioIterator(2, 1024, device="cpu", return_indices=True, **kw))
    want = iter(jai.AudioIterator(2, 1024, return_indices=True, **kw))
    for _ in range(2):
        (a, ia), (b, ib) = next(got), next(want)
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32 and a.device.type == "cpu"
        assert tuple(a.shape) == (2, 1, 1024) and ia == ib
        assert np.array_equal(a.numpy(), np.asarray(b))
    arrays = next(tai.audio_stream(2, 1024, as_tensor=False, **kw))
    assert isinstance(arrays, np.ndarray) and np.array_equal(arrays, np.asarray(
        next(jai.audio_stream(2, 1024, **kw))))


def test_get_one_audio_segment_from_the_demo_corpus(cache):
    """Without AUDIO_PATH both packages write the demo corpus under the cache
    and cut the same segment from it, bit for bit; a batch is one item."""
    got = tai.get_one_audio_segment(2**14, seed=0, device="cpu")
    want = jai.get_one_audio_segment(2**14, seed=0)
    assert tuple(got.shape) == (1, 1, 2**14) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert float(got.abs().max()) == pytest.approx(1.0, abs=1e-6)
    assert sorted(os.listdir(cache / "demo_audio")) == [f"synthetic_{i}.wav" for i in range(4)]
    batch = tai.get_one_audio_batch(3, 2**12, seed=2, device="cpu")
    assert np.array_equal(batch.numpy(), np.asarray(jai.get_one_audio_batch(3, 2**12, seed=2)))


def test_an_empty_audio_path_falls_back_to_the_demo_corpus(cache, tmp_path, monkeypatch):
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("AUDIO_PATH", str(tmp_path / "empty"))
    assert tds._resolve_path() == jds._resolve_path() == str(cache / "demo_audio")
    corpus = small_corpus(tmp_path / "corpus")
    monkeypatch.setenv("AUDIO_PATH", str(corpus))
    assert tds._resolve_path() == str(corpus)


# the article ---------------------------------------------------------------------------------

def test_article_matches_mptpus(tmp_path):
    x = np.sin(np.linspace(0, 300, 4000)).astype(np.float32)
    x[5] = np.nan
    assert t_encode_audio(x, 16000) == j_encode_audio(x, 16000)
    img = np.random.default_rng(9).uniform(0, 1, (70, 600))

    def parts(m):
        return [m.AudioComponent(x, 16000, "a <b>"), m.ImageComponent(img, "map"), "plain text"]

    tart.conjure_article(str(tmp_path / "t.html"), "Title & co", parts(tart), "# Head\nbody")
    jart.conjure_article(str(tmp_path / "j.html"), "Title & co", parts(jart), "# Head\nbody")
    assert (tmp_path / "t.html").read_text() == (tmp_path / "j.html").read_text()
