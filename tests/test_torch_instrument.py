"""The playable instrument (``mptpu/models/instrument.py``,
``scripts/instrument.py``) in the port against ``mptpu`` on JAX-CPU, at
the script's ``--tiny`` model (2^13 samples, context 16, hidden 32, 4
events, STFT 512/256) with parameters seeded in the port and handed to
``mptpu`` as a flax tree: ``damped_sequential``, the schedule row at
half-frame onsets, a render across two windows, the harvested bank, the
demo phrase from its three note sources, ``build_instrument`` from a
``.pkl``, a directory and scaled sizes, and a scripted REPL.

``mptpu`` draws note ``i``'s noise from ``fold_in(PRNGKey(0), i)`` and the
codec's encode noise from ``fold_in(PRNGKey(noise_seed), event)``; both
are fed to the port. Its random latents come from ``PRNGKey(seed)``, which
the port's generator cannot give, so they are fed in where audio is
compared.

Tolerances: ``damped_sequential`` rtol 1e-5 / atol 1e-6 (``mptpu``'s own
test; the port's log-depth scan sums in another order), and within 5e-6
of the largest where damping near 1 sums thousands of samples (each
package's float32 is 1.2e-6 to 1.8e-6 of it from float64); schedule rows and
bank frames identical; rendered audio within 1e-4 of its largest; bank
vectors rtol 1e-4 and 1e-5 of their largest.
"""

import importlib.util
import io
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.data import datastore as jds
from mptpu.models import inference as jinf
from mptpu.models import instrument as jinst
from mptpu.models import siam as js
from mptpu_torch import convert
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.models import inference as tinf
from mptpu_torch.models import instrument as tinst
from mptpu_torch.models import siam as ts
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.train import checkpoint as tckpt
from mptpu_torch.utils import wav as twav

ROOT = Path(__file__).resolve().parent.parent
N = 2**13
# scripts/instrument.py:build's --tiny model
TINY = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=4,
            transform_window_size=512, transform_step_size=256)


def load_script():
    """scripts/instrument.py as a module (its entry point stays under the
    __main__ check)."""
    spec = importlib.util.spec_from_file_location("instrument", ROOT / "scripts" / "instrument.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SCRIPT = load_script()


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
    """MPTPU_CACHE under ``tmp_path`` for both packages, no AUDIO_PATH, the
    working directory ``tmp_path``."""
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    monkeypatch.setattr(jds, "_collection", None)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def uniform(key, size=N):
    return np.array(jax.random.uniform(key, (1, 1, size), minval=-1.0, maxval=1.0))


def note_noise(n_notes):
    """mptpu's render: note i's noise from fold_in(PRNGKey(0), i)."""
    return torch.from_numpy(np.stack([uniform(jax.random.fold_in(jax.random.PRNGKey(0), i))
                                      for i in range(n_notes)]))


def codec_noise(seed):
    """mptpu's codec encode: event i's noise from fold_in(PRNGKey(seed), i)."""
    key = jax.random.PRNGKey(seed)
    return torch.from_numpy(np.stack([uniform(jax.random.fold_in(key, i)) for i in range(4)]))


@pytest.fixture(scope="module")
def pair():
    """The port's seeded tiny model and its flax tree; a fresh instrument
    of each package over them (the port's codec fed mptpu's noise)."""
    tm = ts.SIAMModel(**TINY, generator=torch.Generator().manual_seed(3), device="cpu")
    tree = convert.module_to_flax(tm)

    def make(noise_seed=0):
        j = jinst.PlayableInstrument(jinf.SIAMCodec(model=js.SIAMModel(**TINY),
                                                    checkpoint_dir=None, params=tree,
                                                    seed=noise_seed))
        t = tinst.PlayableInstrument(tinf.SIAMCodec(model=tm, checkpoint_dir=None, params=None,
                                                    noise=codec_noise(noise_seed)))
        return j, t

    return make, tree


def j_vector(seed, dim=16):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (dim,)))


def assert_audio_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---- the recurrence and the schedule ------------------------------------------------------------

@pytest.mark.parametrize("shape,lo,hi", [((2, 3, 16), 0.5, 0.99), ((1, 2, 2**17), 0.5, 0.99),
                                         ((1, 1, 2**17), 0.999, 1.0)])
def test_damped_sequential(shape, lo, hi):
    """Against mptpu's lax.scan, at its test's shape and at a window of 2^17
    samples (17 doubling rounds), damping down to 0.5 and up to 1. Near 1
    the sums run over thousands of samples to magnitudes near 100, and
    each package's float32 stands 1.2e-6 (the port) and 1.8e-6 (mptpu) of
    the largest from the port in float64: there the two are held within
    5e-6 of the largest, elsewhere at mptpu's test's rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal(shape).astype(np.float32)
    d = rng.uniform(lo, hi, shape).astype(np.float32)
    want = np.asarray(jax.jit(jinst.damped_sequential)(jnp.asarray(f), jnp.asarray(d)))
    got = tinst.damped_sequential(torch.from_numpy(f), torch.from_numpy(d)).numpy()
    if hi < 1.0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        t64 = tinst.damped_sequential(torch.from_numpy(f).double(), torch.from_numpy(d).double())
        scale = float(t64.abs().max())
        assert np.abs(got - want).max() <= 5e-6 * scale
        assert np.abs(got - t64.numpy()).max() <= 2e-6 * scale


def test_schedule_row_rounds_half_to_even_and_clamps(pair):
    """Onsets at whole and half frames (Python's round: 2.5 -> 2, 3.5 ->
    4), past the window and before it."""
    make, _ = pair
    j, t = make()
    hop = 256 / 22050
    times = [k * hop for k in range(6)] + [(k + 0.5) * hop for k in range(6)] + [1.0, -0.1]
    frames = []
    for time_s in times:
        want = j._schedule_row(time_s, 0.7)
        got = t._schedule_row(time_s, 0.7)
        np.testing.assert_array_equal(got, want)
        frames.append(int(np.argmax(got)))
    assert frames[6:12] == [round(k + 0.5) for k in range(6)] == [0, 2, 2, 4, 4, 6]
    assert frames[-2:] == [31, 0]


# ---- rendering, harvesting, the demo -------------------------------------------------------------

def test_render_across_two_windows(pair):
    """Three notes, the last in the second window (a window is 0.3715 s),
    each with its own noise: mptpu's audio and length; with one noise for
    every note the audio differs."""
    make, _ = pair
    j, t = make()
    for inst in (j, t):
        inst.add_note(j_vector(0), 0.0)
        inst.add_note(j_vector(1), 0.2, 0.6)
        inst.add_note(j_vector(2), 0.5, 0.8)
    want = j.render()
    got = t.render(noise=note_noise(3))
    assert got.shape == want.shape == (1, 1, int(np.ceil((0.5 + N / 22050) * 22050)))
    assert_audio_close(got, want)
    shared = t.render(noise=note_noise(1).expand(3, -1, -1, -1))
    assert np.abs(shared - want).max() > 1e-2 * np.abs(want).max()
    assert np.array_equal(t.render(total_seconds=2.0, noise=note_noise(3))[..., : got.shape[-1]],
                          got)
    t.clear()
    assert t.render().shape == (1, 1, N) and not t.render().any()


def test_harvest_bank_and_bank_vector(pair):
    """The bank from the codec's encode of a window (the codec's noise of
    seed 5 fed): vectors close, the frames they came from identical."""
    make, _ = pair
    j, t = make(noise_seed=5)
    audio = tsyn.synthetic_audio(N, n_events=6, seed=4, sustained=True).reshape(1, 1, N)
    want = j.harvest_bank(jnp.asarray(audio))
    got = t.harvest_bank(torch.from_numpy(audio))
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    frames = t.codec.encode(torch.from_numpy(audio)).schedules.argmax(-1)
    j_frames = np.asarray(j.codec.encode(jnp.asarray(audio)).schedules).argmax(-1)
    np.testing.assert_array_equal(frames.numpy(), j_frames)
    np.testing.assert_array_equal(t.bank_vector(6), got[2])
    with pytest.raises(ValueError, match="no vector bank"):
        make()[1].bank_vector(0)


@pytest.mark.parametrize("source", ["random", "harvest_wav", "harvest_seed"])
def test_demo_phrase(pair, cache, monkeypatch, source):
    """The script's demo phrase from each note source: mptpu's audio, gain
    and written WAV (the random latents fed in)."""
    make, _ = pair
    j, t = make(noise_seed=2)
    monkeypatch.setattr(t, "random_vector", j_vector)
    kw = {}
    if source == "harvest_wav":
        path = cache / "target.wav"
        twav.write_wav(str(path), tsyn.synthetic_audio(N - 100, n_events=5, seed=8))
        kw = dict(harvest_wav=str(path))
    elif source == "harvest_seed":
        kw = dict(harvest_seed=3)
    want = SCRIPT.demo_phrase(j, str(cache / "j.wav"), **kw)
    lines = []
    got = tinst.demo_phrase(t, str(cache / "t.wav"), noise=note_noise(len(t.notes) or 7),
                            log=lines.append, **kw)
    assert len(t.notes) == (5 if source == "random" else 7)
    assert_audio_close(got, want)
    assert lines[0].startswith("output gain") and lines[1].startswith(f"wrote {cache}/t.wav (")
    a, _ = twav.read_wav(str(cache / "t.wav"))
    b, _ = twav.read_wav(str(cache / "j.wav"))
    assert a.shape == b.shape and np.abs(a - b).max() <= 2 / 32767


# ---- the script's entry points ----------------------------------------------------------------

def test_build_instrument_from_a_pkl_a_directory_and_sizes(pair, tmp_path):
    """build_instrument of a .pkl (as the script's build reads it), of a
    checkpoint directory, of a missing directory (seeded parameters), of
    size overrides; the selection leak and floor set for the process."""
    make, tree = pair
    path = str(tmp_path / "ema_best.pkl")
    tckpt.save_checkpoint(path, tree, None, step=7)
    inst = tinst.build_instrument(path, tiny=True, device="cpu")
    j = SCRIPT.build(path, True)
    got, want = convert.module_to_flax(inst.model)["params"], j.codec.params["params"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tckpt.CheckpointManager(str(tmp_path / "dir"), every=1).maybe_save(3, tree)
    from_dir = tinst.build_instrument(str(tmp_path / "dir"), tiny=True, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(from_dir.model.state_dict().values(),
                                                 inst.model.state_dict().values()))
    seeded = tinst.build_instrument(str(tmp_path / "none"), tiny=True, noise_seed=4, device="cpu")
    assert seeded.codec.seed == 4 and seeded.model.n_samples == N
    sized = tinst.build_instrument(None, size_overrides=dict(
        n_samples=2**14, n_events=2, hidden=16, context_dim=8, window=512, attn_leak=0.1),
        device="cpu")
    assert (sized.model.n_samples, sized.model.in_channels, sized.model.attn_leak) == (
        2**14, 257, 0.1)
    kept = (tq.RELU_SELECTION_LEAK, tq.RELU_SELECTION_FLOOR)
    try:
        tinst.build_instrument(None, tiny=True, selection_leak=0.02, selection_floor=0.03,
                               device="cpu")
        assert (tq.RELU_SELECTION_LEAK, tq.RELU_SELECTION_FLOOR) == (0.02, 0.03)
    finally:
        tq.set_selection_leak(kept[0])
        tq.set_selection_floor(kept[1])
    with open(tmp_path / "bad.pkl", "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(SystemExit, match="unreadable"):
        tinst.build_instrument(str(tmp_path / "bad.pkl"), tiny=True, device="cpu")


def test_scripted_repl_prints_what_the_scripts_does(pair, cache, monkeypatch, capsys):
    """The same commands through the script's REPL (its input() fed) and the
    port's (a stream): the same lines, the rendered WAV of the same length."""
    make, _ = pair
    j, t = make()
    commands = ["note 0.1 0.5 3", "vec 0 0.2", "harvest", "vec 1 0.3 0.7", "", "list",
                "render j.wav", "clear", "list", "bogus", "note", "quit", "note 1"]
    feed = iter(commands)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(feed))
    SCRIPT.repl(j)
    want = capsys.readouterr().out.splitlines()
    lines = []
    tinst.repl(t, io.StringIO("\n".join(c.replace("j.wav", "t.wav") for c in commands) + "\n"),
               log=lines.append)
    assert [ln.replace("t.wav", "j.wav") for ln in lines] == want
    assert "error: no vector bank loaded" in lines and "unknown command 'bogus'" in lines
    shapes = [twav.read_wav(str(cache / f))[0].shape for f in ("t.wav", "j.wav")]
    assert shapes[0] == shapes[1]
