"""mptpu_torch's multiband dictionary learning against mptpu's on the same
numpy inputs: the FFT band decomposition, BandSpec / the
MultibandDictionaryLearning codec, the global event-tuple wire format, a
short learning trajectory and the stored-dictionary format.

mptpu runs on JAX-CPU, the port on device="cpu". mptpu draws its random
dictionaries from jax.random, the port from a torch.Generator, so every
comparison carries mptpu's dictionaries across with
convert.band_dicts_from_jax. Sizes follow
tests/test_matching_pursuit.py:132-217: three bands of 16 atoms x 32 taps
on 2,048 samples. Each tolerance is stated where it is used.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu import ops as jops
from mptpu import sparse as jsp
from mptpu_torch import ops as tops
from mptpu_torch import sparse as tsp
from mptpu_torch.convert import band_dicts_from_jax

N_SAMPLES = 2048
SIZES = (512, 1024, 2048)
N_ATOMS, ATOM_SIZE, STEPS = 16, 32, 8


def make_models(sizes=SIZES, n_samples=N_SAMPLES):
    """(mptpu model, port model) with the same dictionaries."""
    jm = jsp.MultibandDictionaryLearning(
        [jsp.BandSpec(s, N_ATOMS, ATOM_SIZE, signal_samples=n_samples,
                      is_lowest_band=(s == sizes[0])) for s in sizes],
        n_samples,
    )
    dicts = band_dicts_from_jax(jm, device="cpu")
    tm = tsp.MultibandDictionaryLearning(
        [tsp.BandSpec(s, N_ATOMS, ATOM_SIZE, signal_samples=n_samples,
                      is_lowest_band=(s == sizes[0]), d=dicts[s]) for s in sizes],
        n_samples,
    )
    return jm, tm


def planted_signal(jm, batch, seed):
    """A signal with decisive maxima in every band: a few events per band
    with amplitudes falling by 0.75, rendered by mptpu's own decoder."""
    rng = np.random.default_rng(seed)
    events = {}
    for size in jm.bands:
        atoms = rng.integers(0, N_ATOMS, (5, batch)).astype(np.int32)
        pos = rng.integers(0, size - ATOM_SIZE, (5, batch)).astype(np.int32)
        pos[0, :] = size - ATOM_SIZE // 2                      # one clipped event per item
        vals = (4.0 * 0.75 ** np.arange(5))[:, None] * np.ones((1, batch))
        events[size] = jsp.SparseCodeResult(
            jnp.asarray(atoms), jnp.asarray(pos), jnp.asarray(vals.astype(np.float32)), None
        )
    return np.asarray(jm.decode(events, batch)).astype(np.float32)


def snr_db(x, recon):
    x, recon = np.asarray(x, np.float64), np.asarray(recon, np.float64)
    return 10 * np.log10((x**2).sum() / ((x - recon) ** 2).sum())


@pytest.fixture(scope="module")
def pair():
    jm, tm = make_models()
    sig = planted_signal(jm, 2, seed=3)
    j_enc = jm.encode(jnp.asarray(sig), STEPS)
    t_enc = tm.encode(torch.from_numpy(sig), STEPS)
    return jm, tm, sig, j_enc, t_enc


# ---- the filterbank


def test_band_sizes_match_mptpu():
    from mptpu.ops.decompose import band_sizes as j_band_sizes

    for n, m in ((2048, 512), (32768, 512), (1024, 1024), (1000, 256)):
        assert tops.band_sizes(n, m) == j_band_sizes(n, m)


@pytest.mark.parametrize("shape,min_size", [((2, 1, 2048), 512), ((3, 2, 1024), 128)])
def test_fft_frequency_decompose_matches_mptpu(shape, min_size):
    """Ortho rFFT, band masks and irfft at each band's size: atol 1e-5."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    j = jops.fft_frequency_decompose(jnp.asarray(x), min_size)
    t = tops.fft_frequency_decompose(torch.from_numpy(x), min_size)
    assert list(t) == list(j)
    for size in j:
        assert t[size].shape == (*shape[:-1], size) and t[size].dtype == torch.float32
        np.testing.assert_allclose(t[size].numpy(), np.asarray(j[size]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("is_lowest_band", [True, False])
def test_fft_resample_matches_mptpu(is_lowest_band):
    """The band's spectrum placed into the target's coefficient range
    (all of it for the lowest band, its upper half otherwise): atol 1e-5."""
    x = np.random.default_rng(2).standard_normal((2, 1, 256)).astype(np.float32)
    j = jops.fft_resample(jnp.asarray(x), 1024, is_lowest_band)
    t = tops.fft_resample(torch.from_numpy(x), 1024, is_lowest_band)
    assert t.shape == (2, 1, 1024)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_fft_frequency_recompose_matches_mptpu_and_inverts_decompose():
    x = np.random.default_rng(4).standard_normal((2, 1, 2048)).astype(np.float32)
    jb = jops.fft_frequency_decompose(jnp.asarray(x), 512)
    tb = tops.fft_frequency_decompose(torch.from_numpy(x), 512)
    j = jops.fft_frequency_recompose(jb, 2048)
    t = tops.fft_frequency_recompose(tb, 2048)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    # The bands overlap on their edge coefficients, so the sum is not the
    # input; both packages miss it by the same amount.
    np.testing.assert_allclose(snr_db(x, t.numpy()), snr_db(x, j), atol=1e-3)


# ---- BandSpec


def test_bandspec_draws_a_unit_norm_dictionary_on_the_asked_device():
    a = tsp.BandSpec(512, 8, 16, device="cpu")
    b = tsp.BandSpec(512, 8, 16, device="cpu")
    assert a.d.shape == (8, 16) and a.d.device.type == "cpu"
    assert torch.equal(a.d, b.d)                      # seeded by the band size
    assert not torch.equal(a.d, tsp.BandSpec(1024, 8, 16, device="cpu").d)
    np.testing.assert_allclose(a.d.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    gen = torch.Generator().manual_seed(7)
    c = tsp.BandSpec(512, 8, 16, device="cpu", generator=gen)
    assert not torch.equal(a.d, c.d)
    assert a.filename == "band_512.dat" and a.shape(3) == (3, 1, 512)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsp.BandSpec(512, 8, 16)                  # the card unless the CPU is asked for


def test_band_dicts_cross_over_exactly(pair):
    jm, tm = pair[0], pair[1]
    from_dict = band_dicts_from_jax({s: np.asarray(d) for s, d in jm.band_dicts.items()}, "cpu")
    assert list(from_dict) == list(jm.band_dicts) == list(tm.band_dicts)
    for size, d in jm.band_dicts.items():
        np.testing.assert_array_equal(tm.bands[size].d.numpy(), np.asarray(d))
        np.testing.assert_array_equal(from_dict[size].numpy(), np.asarray(d))


def test_model_accessors_match_mptpu(pair):
    jm, tm = pair[0], pair[1]
    assert len(tm) == len(jm) and tm.total_atoms == jm.total_atoms
    assert tm.band_sizes == jm.band_sizes and tm.min_size == jm.min_size
    assert tm.event_count(5) == jm.event_count(5)
    assert tm.shape_dict(3) == jm.shape_dict(3)
    assert tm.size_at_index(1) == jm.size_at_index(1)
    assert tm.index_of_size(2048) == jm.index_of_size(2048)
    assert tm.get_band_from_global_atom_index(20)[0] == jm.get_band_from_global_atom_index(20)[0]
    assert tm.atom_embeddings().shape == jm.atom_embeddings().shape
    with pytest.raises(ValueError):
        tsp.MultibandDictionaryLearning(
            [tsp.BandSpec(512, 8, 16, device="cpu"), tsp.BandSpec(1024, 4, 16, device="cpu")], 1024
        )


def test_resampled_atoms_match_mptpu(pair):
    jm, tm = pair[0], pair[1]
    for size in SIZES:
        j, t = jm.bands[size].resampled_atoms(), tm.bands[size].resampled_atoms()
        assert t.shape == (N_ATOMS, 1, ATOM_SIZE * (N_SAMPLES // size))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


# ---- encode / decode


def test_encode_events_identical_on_a_planted_signal(pair):
    """Atoms and positions identical in every band; values rtol 1e-4 /
    atol 1e-5 and residual rtol 1e-3 / atol 1e-5 as tests/test_fast_mp.py."""
    _, _, _, j_enc, t_enc = pair
    assert list(t_enc) == list(j_enc)
    for size in SIZES:
        j, t = j_enc[size], t_enc[size]
        assert t.atom_indices.shape == (STEPS, 2) and t.atom_indices.dtype == torch.int32
        np.testing.assert_array_equal(t.atom_indices.numpy(), np.asarray(j.atom_indices))
        np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
        np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t.residual.numpy(), np.asarray(j.residual), rtol=1e-3, atol=1e-5)
        assert (t.positions > size - ATOM_SIZE).any()         # the clipped plant was found


def test_decode_and_recon_match_mptpu(pair):
    """Scatter plus recompose of identical events: atol 1e-5."""
    jm, tm, sig, j_enc, t_enc = pair
    j, t = jm.decode(j_enc, 2), tm.decode(t_enc, 2)
    assert t.shape == (2, 1, N_SAMPLES)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    tr, _ = tm.recon(torch.from_numpy(sig), STEPS)
    np.testing.assert_allclose(tr.numpy(), t.numpy(), atol=1e-6, rtol=0)
    assert snr_db(sig, tr.numpy()) > 3.0


def test_event_codec_round_trip(pair):
    """to_global / to_local per band and flattened / hierarchical over the
    model: indices and sample positions come back exactly (band sizes are
    powers of two, so unit time is exact), amplitudes as |value|."""
    jm, tm, _, j_enc, t_enc = pair
    gi, ut, amp = tm.flattened_event_tuples(t_enc)
    jgi, jut, jamp = jm.flattened_event_tuples(j_enc)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(jut))
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), rtol=1e-4, atol=1e-5)
    assert gi.shape == (len(SIZES) * STEPS * 2,) and int(gi.max()) < tm.total_atoms
    assert float(ut.min()) >= 0.0 and float(ut.max()) < 1.0

    offset = 0
    for size in SIZES:
        band, ev = tm.bands[size], t_enc[size]
        back = band.to_local(*band.to_global(ev, offset), offset)
        assert torch.equal(back.atom_indices, ev.atom_indices)
        assert torch.equal(back.positions, ev.positions) and back.positions.dtype == torch.int32
        assert torch.equal(back.values, ev.values.abs())
        offset += band.n_atoms
    # to_sample_time truncates toward zero like astype(int32)
    times = np.array([0.0, 0.4999, 0.9999], np.float32)
    np.testing.assert_array_equal(
        tm.bands[512].to_sample_time(torch.from_numpy(times)).numpy(),
        np.asarray(jm.bands[512].to_sample_time(jnp.asarray(times))),
    )
    routed = tm.hierarchical_event_tuples(gi, ut, amp)
    j_routed = jm.hierarchical_event_tuples(jgi, jut, jamp)
    for size in SIZES:
        np.testing.assert_array_equal(routed[size].atom_indices.numpy(),
                                      np.asarray(j_routed[size].atom_indices))
        np.testing.assert_array_equal(routed[size].positions.numpy(),
                                      np.asarray(j_routed[size].positions))
        assert int((routed[size].values != 0).sum()) == STEPS * 2


def test_decode_global_matches_mptpu_with_and_without_batch_indices(pair):
    """The wire format decodes to what decode gives (values are positive
    here, so |value| loses nothing): atol 1e-5 against mptpu and against
    the port's own decode; explicit batch indices keep the attribution
    under a permutation of a batched stream."""
    jm, tm, _, j_enc, t_enc = pair
    gi, ut, amp = tm.flattened_event_tuples(t_enc)
    jflat = jm.flattened_event_tuples(j_enc)
    t = tm.decode_global(gi, ut, amp, batch_size=2, n_steps=STEPS)
    j = jm.decode_global(*jflat, batch_size=2, n_steps=STEPS)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.numpy(), tm.decode(t_enc, 2).numpy(), atol=1e-5, rtol=0)

    n = gi.shape[0]
    rows = np.arange(n, dtype=np.int32) % 2
    perm = np.random.default_rng(5).permutation(n)
    shuffled = tm.decode_global(gi[perm], ut[perm], amp[perm], batch_size=2,
                                batch_indices=rows[perm])
    np.testing.assert_allclose(shuffled.numpy(), t.numpy(), atol=1e-5, rtol=0)
    j_shuffled = jm.decode_global(*(a[perm] for a in jflat), batch_size=2,
                                  batch_indices=jnp.asarray(rows[perm]))
    np.testing.assert_allclose(shuffled.numpy(), np.asarray(j_shuffled), atol=1e-5, rtol=0)
    # a truncated stream whose length the batch does not divide is padded
    part = tm.decode_global(gi[:5], ut[:5], amp[:5], batch_size=2)
    j_part = jm.decode_global(*(a[:5] for a in jflat), batch_size=2)
    np.testing.assert_allclose(part.numpy(), np.asarray(j_part), atol=1e-5, rtol=0)


def test_decode_global_routes_by_atom_index_under_permutation_at_batch_one():
    """tests/test_matching_pursuit.py:166-189 across the packages."""
    jm, tm = make_models(sizes=(512, 1024), n_samples=1024)
    sig = planted_signal(jm, 1, seed=8)
    t_enc = tm.encode(torch.from_numpy(sig), 4)
    gi, ut, amp = tm.flattened_event_tuples(t_enc)
    canonical = tm.decode_global(gi, ut, amp, batch_size=1)
    perm = np.random.default_rng(5).permutation(gi.shape[0])
    shuffled = tm.decode_global(gi[perm], ut[perm], amp[perm], batch_size=1)
    np.testing.assert_allclose(shuffled.numpy(), canonical.numpy(), rtol=1e-4, atol=1e-5)
    jflat = jm.flattened_event_tuples(jm.encode(jnp.asarray(sig), 4))
    j_shuffled = jm.decode_global(*(a[perm] for a in jflat), batch_size=1)
    np.testing.assert_allclose(shuffled.numpy(), np.asarray(j_shuffled), atol=1e-5, rtol=0)


# ---- learning, storing


def test_two_iteration_learning_trajectory_matches_mptpu():
    """Two learn iterations from the same dictionaries on the same batch.
    Events stay identical, so the dictionaries differ by summation order
    compounded over two Gauss-Seidel sweeps: atol 1e-4; recon SNR within
    0.05 dB of mptpu's, and rising in both."""
    jm, tm = make_models()
    sig = planted_signal(jm, 2, seed=6) + 0.05 * np.random.default_rng(6).standard_normal(
        (2, 1, N_SAMPLES)).astype(np.float32)
    xj, xt = jnp.asarray(sig), torch.from_numpy(sig)
    snr_j = [snr_db(sig, jm.recon(xj, STEPS)[0])]
    snr_t = [snr_db(sig, tm.recon(xt, STEPS)[0].numpy())]
    for _ in range(2):
        jm.learn(xj, STEPS)
        tm.learn(xt, STEPS)
        for size in SIZES:
            np.testing.assert_allclose(tm.bands[size].d.numpy(), np.asarray(jm.bands[size].d),
                                       atol=1e-4, rtol=0)
        snr_j.append(snr_db(sig, jm.recon(xj, STEPS)[0]))
        snr_t.append(snr_db(sig, tm.recon(xt, STEPS)[0].numpy()))
    np.testing.assert_allclose(snr_t, snr_j, atol=0.05, rtol=0)
    assert snr_t[-1] > snr_t[0] and snr_j[-1] > snr_j[0]
    for size in SIZES:
        np.testing.assert_allclose(tm.bands[size].d.norm(dim=-1).numpy(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("writer", ["mptpu", "port"])
def test_store_by_one_package_loads_in_the_other(writer, tmp_path):
    """band_<size>.dat is a pickled numpy array in both packages."""
    jm, tm = make_models(sizes=(512, 1024), n_samples=1024)
    rng = np.random.default_rng(9)
    fresh = {s: rng.standard_normal((N_ATOMS, ATOM_SIZE)).astype(np.float32) for s in (512, 1024)}
    if writer == "mptpu":
        for s, d in fresh.items():
            jm.bands[s].d = jnp.asarray(d)
        jm.store(str(tmp_path))
        tm.load(str(tmp_path))
    else:
        for s, d in fresh.items():
            tm.bands[s].d = torch.from_numpy(d)
        tm.store(str(tmp_path))
        jm.load(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["band_1024.dat", "band_512.dat"]
    for s, d in fresh.items():
        np.testing.assert_array_equal(tm.bands[s].d.numpy(), d)
        np.testing.assert_array_equal(np.asarray(jm.bands[s].d), d)
        assert tm.bands[s].d.dtype == torch.float32
    before = tm.bands[512].d.clone()
    tm.bands[512].load(str(tmp_path / "missing"))          # a missing file changes nothing
    assert torch.equal(tm.bands[512].d, before)
