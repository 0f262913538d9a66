"""The port's data plumbing and host utilities against ``mptpu``'s on the
same inputs: ``Config`` and the ``.env`` keys, ``dumps_json``,
``CompositeComponent``, ``readme``, the remote weight store,
``get_audio_segment``, the native C++ loader, ``fresh_segment_stream``,
``utilization`` / ``trace`` / ``timed`` and ``Mixer``.

Tolerances: everything here is equal to the bit (the same numpy, the same
C++ and the same JSON), except ``Mixer``, whose float32 weighted sum is
held at rtol 1e-6. ``mptpu``'s ``NativeAudioLoader`` builds its library into
``native/`` with its own ``make`` (a gitignored file, as
``tests/test_data.py`` has it do); where that build fails, the port's
loader is held to the Python reader alone.
"""

import json
import os
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu.config import dotenv as jdotenv
from mptpu.data import fetch as jfetch
from mptpu.data import native as jnative
from mptpu.data import synthetic as jsyn
from mptpu.gen.splat import Mixer as JMixer
from mptpu.obs import article as jarticle
from mptpu.utils import jsonio as jjsonio
from mptpu.utils import profile as jprofile
from mptpu.utils import readmedocs as jreadme
from mptpu.utils import remote as jremote
from mptpu_torch.config import dotenv as tdotenv
from mptpu_torch.data import fetch as tfetch
from mptpu_torch.data import native as tnative
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.gen.splat import Mixer as TMixer
from mptpu_torch.obs import article as tarticle
from mptpu_torch.utils import jsonio as tjsonio
from mptpu_torch.utils import profile as tprofile
from mptpu_torch.utils import readmedocs as treadme
from mptpu_torch.utils import remote as tremote
from mptpu_torch.utils.wav import read_wav, write_wav

ENV_KEYS = ("AUDIO_PATH", "IMPULSE_RESPONSE_PATH", "S3_BUCKET", "PORT", "MPTPU_CACHE")


def test_config_reads_the_env_file_as_mptpu(tmp_path, monkeypatch):
    """The five settings from a ``.env`` in the working directory, each
    equal to mptpu's ``Config``'s; a variable already set wins over the
    file in both."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(
        "# comment\nAUDIO_PATH=/data/audio\nIMPULSE_RESPONSE_PATH = /data/ir\n"
        f"S3_BUCKET=weights-bucket\nPORT=8123\nMPTPU_CACHE={tmp_path / 'cache'}\nnot a line\n")
    monkeypatch.setenv("IMPULSE_RESPONSE_PATH", "/set/ir")
    monkeypatch.setattr(jdotenv, "_parsed", False)
    for name in ("audio_path", "impulse_response_path", "s3_bucket", "port", "cache_path"):
        assert getattr(tdotenv.Config, name)() == getattr(jdotenv.Config, name)(), name
    assert tdotenv.Config.port() == 8123
    assert tdotenv.Config.impulse_response_path() == "/set/ir"
    assert os.path.isdir(tmp_path / "cache")


def test_config_defaults_without_env_file(tmp_path, monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jdotenv, "_parsed", False)
    assert tdotenv.Config.s3_bucket() is None is jdotenv.Config.s3_bucket()
    assert tdotenv.Config.port() == jdotenv.Config.port() == 9999
    assert tdotenv.Config.port(1234) == jdotenv.Config.port(1234) == 1234


@pytest.mark.parametrize("case", ["nested", "numpy_float64", "numpy_float32", "array",
                                  "array_default"])
def test_dumps_json_is_mptpus(case):
    """The same text, or the same exception, for non-finite floats in
    nested containers, numpy scalars and arrays."""
    objs = {
        "nested": ({"best": float("-inf"), "evals": [1.5, float("nan"), (2, float("inf"))]}, {}),
        "numpy_float64": ({"x": np.float64("nan"), "y": np.float64(2.5)}, {}),
        "numpy_float32": ({"x": np.float32(1.0)}, {}),
        "array": ({"x": np.arange(3.0)}, {}),
        "array_default": ({"x": np.array([1.0, np.nan])}, {"default": lambda o: o.tolist()}),
    }
    obj, kw = objs[case]

    def run(fn):
        try:
            return fn(obj, indent=1, **kw)
        except (TypeError, ValueError) as e:
            return type(e)

    assert run(tjsonio.dumps_json) == run(jjsonio.dumps_json)
    if case == "nested":
        assert json.loads(run(tjsonio.dumps_json))["best"] is None


def test_composite_component_renders_as_mptpus():
    rng = np.random.default_rng(0)
    audio = (0.5 * rng.standard_normal(2048)).astype(np.float32)

    def build(m):
        inner = m.CompositeComponent([m.TextComponent("## inner\ntext")], title="in <b>")
        return m.CompositeComponent([m.TextComponent("# head\npara"),
                                     m.AudioComponent(audio, 22050, "clip"), inner],
                                    title="outer")

    assert build(tarticle).render() == build(jarticle).render()
    assert tarticle.CompositeComponent().render() == jarticle.CompositeComponent().render()


def test_readme_decorator(tmp_path):
    """``__doc__`` from the readme.md beside the module path; untouched
    without one."""
    with_readme, without = tmp_path / "a", tmp_path / "b"
    with_readme.mkdir()
    without.mkdir()
    (with_readme / "readme.md").write_text("# An experiment\n\nIts notes.\n")
    for where, want in ((with_readme, "# An experiment\n\nIts notes.\n"), (without, "kept")):
        made = []
        for deco in (treadme.readme, jreadme.readme):
            @deco(str(where / "experiment.py"))
            class Experiment:
                """kept"""
            made.append(Experiment.__doc__)
        assert made == [want, want]


def test_remote_store_round_trip(tmp_path, monkeypatch):
    """A checkpoint stored under its date key comes back byte for byte,
    across packages both ways; a missing key loads as None."""
    monkeypatch.setenv("MPTPU_REMOTE_WEIGHTS", str(tmp_path / "remote"))
    src = tmp_path / "ckpt.pkl"
    src.write_bytes(os.urandom(4096))
    assert tremote.weights_key("2024-01-02") == jremote.weights_key("2024-01-02")
    dest = tremote.store_trained_weights_remotely("2024-01-02", str(src))
    assert dest == os.path.join(str(tmp_path / "remote"), "2024-01-02_weights.dat")
    got = jremote.load_trained_weights_for_inference("2024-01-02", str(tmp_path / "j" / "w.dat"))
    assert open(got, "rb").read() == src.read_bytes()
    jremote.store_trained_weights_remotely("2024-01-03", str(src))
    got = tremote.load_trained_weights_for_inference("2024-01-03", str(tmp_path / "t" / "w.dat"))
    assert got == str(tmp_path / "t" / "w.dat") and open(got, "rb").read() == src.read_bytes()
    assert tremote.load_trained_weights_for_inference("1999-01-01", str(tmp_path / "x")) is None


def test_remote_root_defaults_under_the_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("MPTPU_REMOTE_WEIGHTS", raising=False)
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    src = tmp_path / "w.pkl"
    src.write_bytes(b"weights")
    dest = tremote.store_trained_weights_remotely("d", str(src))
    assert dest == str(tmp_path / "cache" / "remote_weights" / "d_weights.dat")


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    """A 16 kHz WAV and a 22,050 Hz one of the same seeded signal."""
    d = tmp_path_factory.mktemp("fetch")
    x = jsyn.synthetic_audio(20000, 16000, seed=4)
    paths = {}
    for sr in (16000, 22050):
        paths[sr] = str(d / f"seg_{sr}.wav")
        write_wav(paths[sr], x, sr)
    return paths


@pytest.mark.parametrize("case", ["file_url", "plain_path", "resample", "zero_pad", "transport"])
def test_get_audio_segment_is_mptpus(case, wav_file):
    """Decode, resample, slice and zero-pad equal to mptpu's to the bit."""
    sr = 22050
    url, start, dur = f"file://{wav_file[sr]}", 1000, 4096
    kw = {}
    if case == "plain_path":
        url = wav_file[sr]
    elif case == "resample":
        url = f"file://{wav_file[16000]}"
    elif case == "zero_pad":
        start = 19000
    elif case == "transport":
        blob = open(wav_file[sr], "rb").read()
        calls = []
        kw = {"transport": lambda u: calls.append(u) or blob}
        url = "s3://bucket/key.wav"
    got = tfetch.get_audio_segment(url, sr, start, dur, **kw)
    want = jfetch.get_audio_segment(url, sr, start, dur, **kw)
    assert got.dtype == np.float32 and got.shape == (dur,)
    np.testing.assert_array_equal(got, want)
    if case == "zero_pad":
        assert np.all(got[1000:] == 0.0)
    if case == "transport":
        assert calls == [url, url]


def test_default_transport_refuses_other_schemes():
    with pytest.raises(ValueError):
        tfetch.default_transport("ftp://host/file.wav")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    paths = []
    for i in range(3):
        p = str(d / f"f{i}.wav")
        write_wav(p, tsyn.synthetic_audio(6000 + 1500 * i, seed=20 + i), 22050)
        paths.append(p)
    return paths


def batches(cls, paths, n, **kw):
    with_close = cls(paths, **kw)
    try:
        return [next(with_close) for _ in range(n)]
    finally:
        with_close.close()


@pytest.mark.parametrize("normalize", [False, True])
def test_native_loader_is_mptpus(normalize, corpus):
    """The port's build of the same C++ gives mptpu's batches to the bit
    (one worker thread: with more, the threads' batches interleave as
    they finish)."""
    assert tnative.native_available(), tnative.build_log
    kw = dict(batch_size=3, n_samples=2048, step_size=64, normalize=normalize, seed=5,
              n_threads=1)
    got = batches(tnative.NativeAudioLoader, corpus, 4, **kw)
    assert all(b.shape == (3, 2048) and b.dtype == np.float32 for b in got)
    if normalize:
        assert np.allclose(np.abs(np.stack(got)).max(-1), 1.0)
    assert not np.array_equal(got[0], got[1])
    again = batches(tnative.NativeAudioLoader, corpus, 4, **kw)
    np.testing.assert_array_equal(np.stack(got), np.stack(again))
    if jnative.native_available():
        want = batches(jnative.NativeAudioLoader, corpus, 4, **kw)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_native_loader_matches_python_reader(tmp_path):
    """tests/test_data.py:97-113's check on the port's loader: a window of
    the whole file starts at 0 and holds the Python reader's samples."""
    x = jsyn.synthetic_audio(4096, seed=3)
    path = str(tmp_path / "check.wav")
    write_wav(path, x, 22050)
    (b,) = batches(tnative.NativeAudioLoader, [path], 1, batch_size=1, n_samples=4096,
                   step_size=4096, seed=0)
    y, _ = read_wav(path)
    np.testing.assert_allclose(b[0][: len(y)], y, atol=2e-4)


def test_native_build_lives_under_build(corpus):
    """The library is built from mptpu_torch/native into build/, and
    nothing of the port's is written under native/."""
    assert tnative.native_available()
    lib = tnative._lib_path()
    root = os.path.dirname(os.path.dirname(os.path.dirname(tnative.__file__)))
    assert lib.exists()
    assert str(lib).startswith(os.path.join(root, "build", "mptpu_torch_native") + os.sep)
    assert tnative.SOURCE == tnative.Path(root) / "mptpu_torch" / "native" / "dataloader.cpp"
    assert not any(n.startswith("libmptpu_torch") for n in os.listdir(os.path.join(root,
                                                                                   "native")))


def test_fresh_segment_stream_is_mptpus():
    """Batches equal to mptpu's to the bit for the same seed base, shaped
    (batch, 1, n), each example's largest magnitude 1, a shifted base (the
    resume path) giving the later batch; closing stops the thread."""
    before = threading.active_count()
    t = tsyn.fresh_segment_stream(2, 4096, seed_base=500_000, prefetch=1)
    j = jsyn.fresh_segment_stream(2, 4096, seed_base=500_000, prefetch=1)
    b0, b1 = next(t), next(t)
    np.testing.assert_array_equal(b0, next(j))
    np.testing.assert_array_equal(b1, next(j))
    assert b0.shape == (2, 1, 4096) and b0.dtype == np.float32
    np.testing.assert_allclose(np.abs(b0).max(-1), 1.0, atol=1e-3)
    shifted = tsyn.fresh_segment_stream(2, 4096, seed_base=500_002, prefetch=1)
    np.testing.assert_array_equal(next(shifted), b1)
    t.close()
    shifted.close()
    deadline = time.time() + 10
    while threading.active_count() > before + 1 and time.time() < deadline:   # mptpu's stays
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_utilization_is_mptpus_with_the_cards_peaks():
    """The same shares as mptpu's for the same peaks; the defaults are the
    SXM H100's (3.35 TB/s, 67 TFLOP/s f32), not a TPU's."""
    for kw in (dict(flops=2e12, bytes_moved=1e10, peak_flops=1e14, peak_bytes_per_s=2e12),
               dict(flops=0.0, bytes_moved=5e9, peak_flops=1e14, peak_bytes_per_s=2e12)):
        got, want = tprofile.utilization(0.25, **kw), jprofile.utilization(0.25, **kw)
        assert (got.mfu, got.hbm_util) == (want.mfu, want.hbm_util)
        assert str(got) == str(want)
    u = tprofile.utilization(2.0, flops=67e12, bytes_moved=3.35e12)
    assert (u.mfu, u.hbm_util) == (0.5, 0.5)
    assert tprofile.device_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert tprofile.device_peaks("NVIDIA H100 PCIe") == (2.0e12, 51e12)


def test_trace_and_timed(tmp_path):
    """A Chrome trace of the block in a new file under the given
    directory; ``timed`` the best of its calls."""
    x = torch.ones(256, 256)
    with tprofile.trace(str(tmp_path / "prof")) as path:
        (x @ x).sum()
    assert os.path.dirname(path) == str(tmp_path / "prof")
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    calls = []
    assert tprofile.timed(lambda a: calls.append(a) or a @ a, x, repeats=3) > 0
    assert len(calls) == 3


def test_mixer_is_mptpus():
    rng = np.random.default_rng(1)
    sigs = [rng.standard_normal((2, 3, 64)).astype(np.float32) for _ in range(2)]
    mix = rng.uniform(size=(2, 3, 1, 2)).astype(np.float32)
    got = TMixer()([torch.from_numpy(s) for s in sigs], torch.from_numpy(mix))
    want = JMixer()([jnp.asarray(s) for s in sigs], jnp.asarray(mix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
