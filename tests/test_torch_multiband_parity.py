"""The multiband learning trajectory of the port
(``mptpu_torch.models.multiband_parity.parity_trajectory``) against
``mptpu``'s ``MultibandDictionaryLearning`` on JAX-CPU, iteration by
iteration, from the same starting dictionaries (``np.random.default_rng(99)``
uniforms, unit-normed) and batch (``synthetic_audio(n, seed=100 + i)``) as
``scripts/multiband_parity.py``, at 3 bands of 16 atoms x 32 taps on 2,048
samples, 8 steps a band, batch 2, over 2 iterations. The script is loaded
with ``importlib`` for its reference mount (``REF``); the reference
implementation is absent from this image, so its side skips, as
``tests/test_torch_parity.py`` does.

Tolerances: the SNR at every iteration within 0.01 dB; the encode's events
identical; each band's dictionary within 1e-4 after every iteration.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu.ops.norms import unit_norm as j_unit_norm
from mptpu.sparse import BandSpec as JBand
from mptpu.sparse import MultibandDictionaryLearning as JModel
from mptpu_torch.models import multiband_parity as mbp

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n_samples=2048, n_atoms=16, atom_size=32, steps=8, batch_size=2,
             sizes=(512, 1024, 2048))
ITERATIONS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def jax_model(init, n):
    sizes = sorted(init)
    return JModel([JBand(s, init[s].shape[0], SMALL["atom_size"], signal_samples=n,
                         is_lowest_band=(s == sizes[0]), d=j_unit_norm(jnp.asarray(init[s])))
                   for s in sizes], n_samples=n)


def j_snr(model, batch, steps):
    recon, _ = model.recon(batch, steps)
    return 10.0 * np.log10(float(jnp.sum(batch**2)) / max(float(jnp.sum((batch - recon) ** 2)),
                                                            1e-12))


@pytest.fixture(scope="module")
def trajectories():
    """(mptpu's SNRs and dictionaries after each iteration, the port's
    result)."""
    init = mbp.initial_dictionaries(SMALL["n_atoms"], SMALL["atom_size"], SMALL["sizes"])
    batch = jnp.asarray(mbp.parity_batch(SMALL["n_samples"], SMALL["batch_size"]))
    jm = jax_model(init, SMALL["n_samples"])
    snrs, dicts = [j_snr(jm, batch, SMALL["steps"])], []
    for _ in range(ITERATIONS):
        jm.learn(batch, SMALL["steps"])
        snrs.append(j_snr(jm, batch, SMALL["steps"]))
        dicts.append({s: np.asarray(b.d) for s, b in jm.bands.items()})
    port = mbp.parity_trajectory(ITERATIONS, device="cpu", reference=None, log=lambda s: None,
                                 **SMALL)
    return snrs, dicts, jm, port, batch


def test_the_starting_point_is_the_scripts():
    """The dictionaries and batch drawn as ``scripts/multiband_parity.py:86-94``
    draws them (at its full configuration)."""
    rng = np.random.default_rng(99)
    want = {s: rng.uniform(-1, 1, (512, 128)).astype(np.float32) for s in mbp.SIZES}
    got = mbp.initial_dictionaries(512, 128, mbp.SIZES)
    assert list(got) == list(want) and all(np.array_equal(got[s], want[s]) for s in want)
    from mptpu.data.synthetic import synthetic_audio as j_synthetic_audio

    batch = np.stack([j_synthetic_audio(2**15, seed=100 + i) for i in range(2)]).reshape(2, 1, -1)
    assert np.array_equal(mbp.parity_batch(2**15, 2), batch)


def test_snr_trajectory_matches_mptpu(trajectories):
    snrs, _, _, port, _ = trajectories
    rows = port["rows"]
    assert [r["iteration"] for r in rows] == list(range(ITERATIONS + 1))
    for want, row in zip(snrs, rows, strict=True):
        assert abs(row["ours_snr_db"] - want) <= 0.01, (row, want)
    assert rows[-1]["ours_snr_db"] > rows[0]["ours_snr_db"]
    assert "ref_snr_db" not in rows[0]


def test_learned_dictionaries_and_events_match_mptpu(trajectories):
    _, dicts, jm, port, batch = trajectories
    model = port["model"]
    for s, d in dicts[-1].items():
        assert np.abs(model.bands[s].d.numpy() - d).max() <= 1e-4, s
    j_enc = jm.encode(batch, SMALL["steps"])
    t_enc = model.encode(torch.from_numpy(np.array(batch)), SMALL["steps"])
    for s in j_enc:
        assert np.array_equal(t_enc[s].atom_indices.numpy(), np.asarray(j_enc[s].atom_indices))
        assert np.array_equal(t_enc[s].positions.numpy(), np.asarray(j_enc[s].positions))


def test_unknown_settings_raise():
    with pytest.raises(TypeError):
        mbp.parity_trajectory(0, device="cpu", reference=None, bands=3)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("multiband_parity_script",
                                                  ROOT / "scripts" / "multiband_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_side_is_skipped_without_the_mount(tmp_path):
    """No reference side where the directory named is absent (the rows
    carry the port's figures only)."""
    out = mbp.parity_trajectory(0, device="cpu", reference=str(tmp_path / "absent"),
                                log=lambda s: None, **SMALL)
    assert set(out["rows"][0]) == {"iteration", "ours_learn_s", "ours_snr_db"}


def test_reference_side_runs_beside_the_port(script):
    """At the script's mount (``REF``), where it exists, the reference
    implementation learns beside the port within 0.1 dB."""
    if not os.path.isdir(script.REF):
        pytest.skip("the reference implementation is not mounted in this image")
    out = mbp.parity_trajectory(1, device="cpu", reference=script.REF, log=lambda s: None,
                                **SMALL)
    for row in out["rows"]:
        assert abs(row["delta_db"]) <= 0.1


def test_chip_phase_rehearsal():
    """``chip_smoke.last_scripts_phase`` (phase 15) end to end on the CPU at
    ``SCRIPTS_SMALL``: every part, its gates and the CPU's three processes;
    no kernel launches off a card."""
    import chip_smoke
    from mptpu_torch.utils.profile import device_peaks

    records = {"cuda_fused_step_pipelined": {}}
    chip_smoke.last_scripts_phase(torch.device("cpu"), chip_smoke.SCRIPTS_SMALL,
                                  device_peaks("H100"), lambda: None, records)
    assert records["cuda_fused_step_pipelined"]["launches_multiband_parity"] == 0


def test_chip_phase_splat_target_is_in_name_order(tmp_path, monkeypatch):
    """Phase 15's splat target, ``get_one_audio_segment(seed=0)`` under
    ``chip_smoke.corpus_in_name_order``, is the same segment whatever order
    the file system lists the demo corpus in (``os.walk``'s, here reversed
    and rotated, two orders that put different files at the draw's index);
    with ``seed=0`` an unseeded stream (phase 15 (e)'s template) draws the
    same segment; the listing and the stream are restored after the block."""
    import chip_smoke
    from mptpu_torch.data import AudioIterator, audioiter, datastore, get_one_audio_segment

    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    walk = os.walk
    targets = []
    for order in (lambda f: sorted(f, reverse=True), lambda f: sorted(f)[2:] + sorted(f)[:2]):
        monkeypatch.setattr(os, "walk", lambda base, walk=walk, order=order: (
            (d, sub, order(files)) for d, sub, files in walk(base)))
        listing, stream = datastore.iter_files, audioiter.batch_stream
        with chip_smoke.corpus_in_name_order():
            targets.append(get_one_audio_segment(2**12, seed=0, device="cpu").numpy())
        with chip_smoke.corpus_in_name_order(seed=0):
            unseeded = AudioIterator(1, 2**12, normalize=True, overfit=True, device="cpu")
            targets.append(next(iter(unseeded)).numpy())
        assert datastore.iter_files is listing and audioiter.batch_stream is stream
    monkeypatch.setattr(os, "walk", walk)
    assert float(np.abs(targets[0]).max()) > 0
    for got in targets[1:]:
        np.testing.assert_array_equal(got, targets[0])
