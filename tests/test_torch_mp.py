"""mptpu_torch.sparse.matching_pursuit against mptpu's naive greedy MP on
the same numpy inputs (JAX on the CPU, the port on device="cpu").

Signals are planted atom sums with decisive maxima: on iid noise, argmax
near-ties flip on last-ulp differences between two frameworks'
convolutions. Tolerances are tests/test_fast_mp.py's: events identical,
values rtol 1e-4 / atol 1e-5, residual rtol 1e-3 / atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu import sparse as jsp
from mptpu.ops import unit_norm as j_unit_norm
from mptpu_torch import sparse as tsp

RNG = np.random.default_rng(21)


def planted(d, batch, n, seed):
    """Atom sums at scattered positions, amplitudes falling by 0.8, plus
    one plant clipped at the end of each item."""
    rng = np.random.default_rng(seed)
    du = np.asarray(j_unit_norm(jnp.asarray(d.reshape(d.shape[0], -1)))).reshape(d.shape)
    du = du if du.ndim == 3 else du[:, None, :]
    n_atoms, channels, A = du.shape
    sig = np.zeros((batch, channels, n), np.float32)
    for i in range(batch):
        for k in range(8):
            pos = int(rng.integers(0, n - A))
            sig[i, :, pos : pos + A] += du[int(rng.integers(n_atoms))] * (5.0 * 0.8**k)
        sig[i, :, -A // 2 :] += du[int(rng.integers(n_atoms)), :, : A // 2] * 4.0
    return sig


def assert_same(j, t):
    np.testing.assert_array_equal(t.atom_indices.numpy(), np.asarray(j.atom_indices))
    np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.residual.numpy(), np.asarray(j.residual), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize(
    "d_shape,kw",
    [((16, 64), {}), ((8, 2, 64), {}), ((16, 64), dict(use_fft=True))],
    ids=["mono", "two_channel", "fft"],
)
def test_sparse_code_matches_mptpu(d_shape, kw):
    d = RNG.standard_normal(d_shape).astype(np.float32)
    sig = planted(d, 2, 1024, seed=len(d_shape) + len(kw))
    j = jsp.sparse_code(jnp.asarray(sig), jnp.asarray(d), n_steps=9, **kw)
    t = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(d), n_steps=9, **kw)
    assert t.atom_indices.dtype == torch.int32 and t.positions.dtype == torch.int32
    assert t.values.dtype == torch.float32
    # the clipped plant was picked and subtracted with clipping
    assert (t.positions > 1024 - d_shape[-1]).any()
    assert_same(j, t)


def test_sparse_code_accepts_2d_signal():
    d = RNG.standard_normal((8, 32)).astype(np.float32)
    sig = planted(d, 2, 256, seed=5)[:, 0, :]
    j = jsp.sparse_code(jnp.asarray(sig), jnp.asarray(d), n_steps=4)
    t = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(d), n_steps=4)
    assert t.residual.shape == (2, 1, 256)
    assert_same(j, t)


@pytest.mark.parametrize("channels", [1, 2])
def test_scatter_events_matches_mptpu(channels):
    S, B, N, A, n = 5, 3, 8, 32, 200
    d = RNG.standard_normal((N, channels, A)).astype(np.float32)
    atoms = RNG.integers(0, N, (S, B)).astype(np.int32)
    pos = RNG.integers(0, n, (S, B)).astype(np.int32)   # some run past the end
    pos[0, 0] = pos[1, 0] = 40                          # overlapping events add
    vals = RNG.standard_normal((S, B)).astype(np.float32)
    args = (atoms, pos, vals, d)
    j = jsp.scatter_events(*(jnp.asarray(a) for a in args), n, channels=channels, batch=4)
    t = tsp.scatter_events(*(torch.from_numpy(a) for a in args), n, channels=channels, batch=4)
    assert t.shape == (4, channels, n)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_reconstruct_from_events_matches_mptpu_and_closes_the_residual():
    d = RNG.standard_normal((16, 64)).astype(np.float32)
    sig = planted(d, 2, 1024, seed=9)
    j = jsp.sparse_code(jnp.asarray(sig), jnp.asarray(d), n_steps=9)
    t = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(d), n_steps=9)
    jr = jsp.reconstruct_from_events(j, jnp.asarray(d))
    tr = tsp.reconstruct_from_events(t, torch.from_numpy(d))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)
    # signal = reconstruction + residual, clipped energy dropped in both
    np.testing.assert_allclose((tr + t.residual).numpy(), sig, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "d_shape,kw",
    [((16, 64), {}), ((16, 1, 64), {}), ((8, 2, 64), {}), ((16, 64), dict(use_fft=True))],
    ids=["2d_mono", "3d_mono", "3d_two_channel", "2d_fft"],
)
def test_dictionary_learning_step_matches_mptpu(d_shape, kw):
    """One sweep on a planted signal with a clipped event and at least one
    unused atom. Events are identical, so the learned dictionary differs
    only by the order of float32 sums: atol 1e-5."""
    d = RNG.standard_normal(d_shape).astype(np.float32)
    channels = d_shape[1] if len(d_shape) == 3 else 1
    sig = planted(d, 2, 1024, seed=11 + len(d_shape) + len(kw))[:, :channels]
    coded = tsp.sparse_code(torch.from_numpy(sig), torch.from_numpy(d), n_steps=7)
    assert (coded.positions > 1024 - d_shape[-1]).any()              # a clipped event
    assert len(torch.unique(coded.atom_indices)) < d_shape[0]        # an unused atom
    j = jsp.dictionary_learning_step(jnp.asarray(sig), jnp.asarray(d), n_steps=7, **kw)
    t = tsp.dictionary_learning_step(torch.from_numpy(sig), torch.from_numpy(d), n_steps=7, **kw)
    assert t.shape == d.shape and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    # unit norm over all non-leading dims; unused atoms keep their direction
    flat = t.reshape(d_shape[0], -1)
    np.testing.assert_allclose(flat.norm(dim=-1).numpy(), 1.0, rtol=1e-4)
    unused = sorted(set(range(d_shape[0])) - set(coded.atom_indices.reshape(-1).tolist()))
    d_unit = torch.from_numpy(d).reshape(d_shape[0], -1)
    d_unit = d_unit / d_unit.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(flat[unused].numpy(), d_unit[unused].numpy(), atol=1e-6)


def test_dictionary_learning_step_accepts_2d_signal_and_learns():
    """Ten sweeps on a two-atom signal family lower the coding residual
    (tests/test_matching_pursuit.py:100-111), in step with mptpu."""
    true_d = RNG.standard_normal((2, 16)).astype(np.float32)
    true_d /= np.linalg.norm(true_d, axis=-1, keepdims=True)
    sig = np.zeros((1, 128), np.float32)
    sig[0, 20:36] += 2.0 * true_d[0]
    sig[0, 70:86] += 1.5 * true_d[1]
    d0 = RNG.standard_normal((4, 16)).astype(np.float32)
    dj, dt = jnp.asarray(d0), torch.from_numpy(d0)
    r0 = tsp.sparse_code(torch.from_numpy(sig), dt, n_steps=2).residual
    for _ in range(10):
        dj = jsp.dictionary_learning_step(jnp.asarray(sig), dj, n_steps=2)
        dt = tsp.dictionary_learning_step(torch.from_numpy(sig), dt, n_steps=2)
    r1 = tsp.sparse_code(torch.from_numpy(sig), dt, n_steps=2).residual
    assert float(r1.norm()) < float(r0.norm())
    # ten Gauss-Seidel sweeps compound the rounding of each: atol 1e-4
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=0)


def test_first_selection_groups_order():
    """Atoms are visited in first-selection order, step-major and
    batch-minor; each atom's events keep their order."""
    from mptpu_torch.sparse.matching_pursuit import _first_selection_groups

    ai = torch.tensor([[5, 2], [2, 7], [5, 5], [0, 7]], dtype=torch.int32)   # (S=4, B=2)
    atoms, order, bounds = _first_selection_groups(ai)
    assert atoms == [5, 2, 7, 0]
    groups = [order[lo:hi].tolist() for lo, hi in zip(bounds[:-1], bounds[1:])]
    assert groups == [[0, 4, 5], [1, 2], [3, 7], [6]]
