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
