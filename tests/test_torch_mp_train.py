"""The port's ``mp_train`` (``mptpu_torch.models.mp_train``) against
``scripts/mp_train.py`` on JAX-CPU at the script's ``--tiny`` widths (64
atoms x 128 taps, 4,096 samples, 16 steps, 4 sweeps, batch 2). The script
is loaded as a module, its ``AudioIterator`` replaced by the same five
seeded batches both packages get; the flat dictionary starts from
``mptpu``'s ``uniform(PRNGKey(0), (64, 128), -1, 1)``, the multiband
dictionaries from ``mptpu``'s ``PRNGKey(size)`` draws, carried by
``convert.band_dicts_from_jax``.

Tolerances: events identical; a learned dictionary within 1e-5 abs of
``mptpu``'s (unit-norm atoms of float32 sums taken in other orders); the
reported SNRs within 0.05 dB of the script's printed ones (two decimals).
No gate on whether the SNR rises at this size: that is the card's, at full
width.
"""

import contextlib
import importlib.util
import io
import os
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu import sparse as jsp
from mptpu_torch import sparse as tsp
from mptpu_torch.convert import band_dicts_from_jax
from mptpu_torch.data import synthetic_audio
from mptpu_torch.models import mp_train as tm

ROOT = Path(__file__).resolve().parent.parent
T = tm.TINY
N = T["n_samples"]
BATCHES = [np.stack([synthetic_audio(N, seed=100 + 2 * k + i)[None] for i in range(2)])
           for k in range(T["sweeps"] + 1)]
REPORT = re.compile(r"sweep (\d+): (?:recon )?SNR (-?[\d.]+) dB")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def script():
    """scripts/mp_train.py as a module."""
    spec = importlib.util.spec_from_file_location("mp_train_script", ROOT / "scripts" /
                                                  "mp_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_d0():
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), (T["n_atoms"], T["atom_size"]),
                                       minval=-1, maxval=1))


def port_stream():
    return [torch.from_numpy(b) for b in BATCHES]


def run_script(script, monkeypatch, fn):
    """(what the script's ``fn`` returns, the SNRs it prints by sweep, its
    initial SNR), fed ``BATCHES``."""
    monkeypatch.setattr(script, "AudioIterator",
                        lambda *a, **k: [jnp.asarray(b) for b in BATCHES])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = getattr(script, fn)(T["n_atoms"], T["atom_size"], N, T["n_steps"], T["sweeps"],
                                  T["batch_size"], None)
    text = buf.getvalue()
    initial = float(re.search(r"initial (?:recon|multiband) SNR[^:]*: (-?[\d.]+) dB",
                              text).group(1))
    return out, {int(i): float(s) for i, s in REPORT.findall(text)}, initial


def test_each_sweep_from_mptpus_dictionary():
    """Every sweep of the flat run from mptpu's dictionary before it: the
    coder's events identical, the learned dictionary within 1e-5."""
    code = jax.jit(lambda s, d: jsp.sparse_code(s, d, n_steps=T["n_steps"]))
    learn = jax.jit(lambda s, d: jsp.dictionary_learning_step(s, d, n_steps=T["n_steps"]))
    d = jnp.asarray(jax_d0())
    for batch in BATCHES[1:]:
        j_ev = code(jnp.asarray(batch), d)
        t_ev = tsp.sparse_code(torch.from_numpy(batch), torch.from_numpy(np.array(d)),
                               n_steps=T["n_steps"])
        np.testing.assert_array_equal(t_ev.atom_indices.numpy(), np.asarray(j_ev.atom_indices))
        np.testing.assert_array_equal(t_ev.positions.numpy(), np.asarray(j_ev.positions))
        t_d = tsp.dictionary_learning_step(torch.from_numpy(batch),
                                           torch.from_numpy(np.array(d)), n_steps=T["n_steps"])
        d = learn(jnp.asarray(batch), d)
        assert np.abs(t_d.numpy() - np.asarray(d)).max() <= 1e-5


def test_flat_run_reports_mptpus_snrs(script, monkeypatch):
    """A whole 4-sweep run: the initial SNR and each report within 0.05 dB
    of the script's, at the same sweeps; the final dictionaries within
    1e-5."""
    j_d, j_reports, j_initial = run_script(script, monkeypatch, "train_flat")
    lines = []
    r = tm.train_flat(**T, stream=port_stream(), d=torch.from_numpy(jax_d0()), device="cpu",
                      log=lines.append)
    assert [s for s, _, _ in r.reports] == sorted(j_reports) == [0, 3]
    assert abs(r.initial_snr_db - j_initial) <= 0.05
    for sweep, snr, rate in r.reports:
        assert abs(snr - j_reports[sweep]) <= 0.05
        assert rate > 0
    assert np.abs(r.learned.numpy() - np.asarray(j_d)).max() <= 1e-5
    assert lines[0].startswith(f"initial recon SNR @ {T['n_steps']} atoms: ")


def test_multiband_run_and_store_load(script, monkeypatch, tmp_path):
    """The multiband run from mptpu's band dictionaries: its initial and
    reported SNRs within 0.05 dB of the script's (which stores into
    ``trained_weights`` under the working directory, here a temporary
    one), the learned bands within 1e-5 of the script's stored ones; the
    port's ``store(out)`` then ``load(out)`` into another model gives its
    dictionaries to the bit."""
    monkeypatch.chdir(tmp_path)
    j_model, j_reports, j_initial = run_script(script, monkeypatch, "train_multiband")
    j_dicts = band_dicts_from_jax(script.MultibandDictionaryLearning(
        [script.BandSpec(s, n_atoms=T["n_atoms"], atom_size=T["atom_size"], signal_samples=N,
                         is_lowest_band=(s == 512)) for s in tm.BAND_SIZES if s <= N], N),
        device="cpu")
    model = tm.multiband_model(T["n_atoms"], T["atom_size"], N, "cpu")
    for size, band in model.bands.items():
        band.d = j_dicts[size]
    out = str(tmp_path / "port_out")
    r = tm.train_multiband(out, **T, stream=port_stream(), model=model, device="cpu",
                           log=lambda s: None)
    assert abs(r.initial_snr_db - j_initial) <= 0.05
    assert [s for s, _, _ in r.reports] == sorted(j_reports)
    for sweep, snr, n_events in r.reports:
        assert abs(snr - j_reports[sweep]) <= 0.05
        assert n_events == 2 * T["n_steps"] * len(model.bands)
    stored = tsp.MultibandDictionaryLearning(
        [tsp.BandSpec(s, T["n_atoms"], T["atom_size"], signal_samples=N, device="cpu")
         for s in model.bands], N)
    stored.load(out)
    mptpu_stored = tsp.MultibandDictionaryLearning(
        [tsp.BandSpec(s, T["n_atoms"], T["atom_size"], signal_samples=N, device="cpu")
         for s in model.bands], N)
    mptpu_stored.load(str(tmp_path / "trained_weights"))
    for size, band in model.bands.items():
        assert torch.equal(stored.bands[size].d, band.d)
        assert np.abs(mptpu_stored.bands[size].d.numpy() - band.d.numpy()).max() <= 1e-5
        assert np.abs(np.asarray(j_model.bands[size].d) - band.d.numpy()).max() <= 1e-5


def test_trainers_write_only_into_out(tmp_path, monkeypatch):
    """Run from a working directory of their own, the flat trainer writes
    nothing and the multiband one only its bands into ``out``."""
    monkeypatch.chdir(tmp_path)
    small = dict(T, n_atoms=16, sweeps=1, n_steps=4)
    tm.train_flat(**small, stream=port_stream(), device="cpu", log=lambda s: None)
    assert os.listdir(tmp_path) == []
    tm.train_multiband("out", **small, stream=port_stream(), device="cpu", log=lambda s: None)
    assert os.listdir(tmp_path) == ["out"]
    assert sorted(os.listdir(tmp_path / "out")) == [f"band_{s}.dat" for s in (1024, 2048, 4096,
                                                                              512)]
