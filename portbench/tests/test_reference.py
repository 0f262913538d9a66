"""The plain reference against brute force at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench.reference import learn as ref_learn
from portbench.reference import mp as ref
from portbench.reference import multiband as ref_mb


def brute_correlation(r, d):
    """(N, n): sum_k r[t + k] d[a, k], r zero past its end."""
    n, (N, A) = len(r), d.shape
    out = np.zeros((N, n))
    for a in range(N):
        for t in range(n):
            out[a, t] = sum(r[t + k] * d[a, k] for k in range(A) if t + k < n)
    return out


def brute_mp(x, d, steps):
    """Greedy MP recomputing the whole map each step."""
    d = d / (np.sqrt(np.maximum((d * d).sum(-1, keepdims=True), 1e-16)) + 1e-8)
    r = x.astype(np.float64).copy()
    n, A = len(r), d.shape[1]
    events = []
    for _ in range(steps):
        c = brute_correlation(r, d)
        a, t = np.unravel_index(np.argmax(c), c.shape)
        v = c[a, t]
        m = min(A, n - t)
        r[t : t + m] -= v * d[a, :m]
        events.append((a, t, v))
    return events, r


@pytest.fixture
def problem():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((5, 6))
    x = rng.standard_normal((2, 23))
    x[0, 20:] += 4.0 * d[2, :3]   # a strong atom clipped at the end
    return x, d


def test_greedy_matches_brute_force(problem):
    x, d = problem
    atoms, positions, values, residual = ref.greedy(torch.from_numpy(x), torch.from_numpy(d), 7)
    for b in range(2):
        events, r = brute_mp(x[b], d, 7)
        assert [(int(a), int(t)) for a, t, _ in events] == list(
            zip(atoms[:, b].tolist(), positions[:, b].tolist()))
        np.testing.assert_allclose(values[:, b].numpy(), [v for *_, v in events], rtol=1e-12)
        np.testing.assert_allclose(residual[b].numpy(), r, atol=1e-12)


def test_follow_measures_the_events(problem):
    x, d = problem
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    atoms, positions, values, residual = ref.greedy(xt, dt, 7)
    err, res, ref_values = ref.follow(xt, dt, atoms, positions, values)
    assert float(err.max()) < 1e-12
    assert torch.allclose(res, residual) and torch.allclose(ref_values, values)
    # the second best instead of the best at one step: the gap shows
    p = ref.Pursuit(xt, dt)
    flat = p.map.reshape(2, -1)
    second = flat.topk(2, dim=-1).indices[:, 1]
    alt_atoms, alt_pos = atoms.clone(), positions.clone()
    alt_atoms[0] = second % 5
    alt_pos[0] = second // 5 - 5
    err, _, _ = ref.follow(xt, dt, alt_atoms, alt_pos, values)
    assert float(err.min()) > 1e-6
    # an event out of range is infinitely wrong
    bad = positions.clone()
    bad[3, 1] = 23
    assert float(ref.follow(xt, dt, atoms, bad, values)[0][1]) == float("inf")


def brute_update(x, d, atoms, positions, values):
    """The sweep's update, one event at a time."""
    def un(v):
        return v / (np.sqrt(max((v * v).sum(), 1e-16)) + 1e-8)
    B, n = x.shape
    A = d.shape[1]
    dd = np.array([un(r) for r in d])
    res = np.zeros((B, n + A))
    res[:, :n] = x
    order = []
    for a in atoms.reshape(-1):
        if a not in order:
            order.append(a)
    evs = [(atoms[s, b], b, positions[s, b], values[s, b])
           for s in range(atoms.shape[0]) for b in range(B)]
    for a in order:
        mine = [(b, p, v) for aa, b, p, v in evs if aa == a]
        for b, p, v in mine:
            res[b, p : p + A] += v * dd[a]
            res[:, n:] = 0
        new = un(sum(res[b, p : p + A] for b, p, _ in mine))
        dd[a] = new
        for b, p, v in mine:
            res[b, p : p + A] -= abs(v) * new
            res[:, n:] = 0
    return np.array([un(r) for r in dd])


def test_learning_update_matches_one_event_at_a_time(problem):
    x, d = problem
    atoms, positions, values, _ = ref.greedy(torch.from_numpy(x), torch.from_numpy(d), 9)
    got = ref_learn.learning_update(x, d, atoms.numpy(), positions.numpy(), values.numpy())
    want = brute_update(x, d, atoms.numpy(), positions.numpy(), values.numpy())
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert not np.allclose(got, d / np.linalg.norm(d, axis=-1, keepdims=True))


def test_octave_bands_hold_their_frequencies():
    n, sr = 2048, 2048
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * 700 * t)[None]          # coefficient 700: band 2048
    bands = ref_mb.decompose(x, 512)
    assert sorted(bands) == [512, 1024, 2048]
    energy = {s: float((b ** 2).sum()) for s, b in bands.items()}
    assert energy[2048] > 1e3 * (energy[512] + energy[1024])
    up = ref_mb.resample(bands[2048], n, False)
    np.testing.assert_allclose(up, x, atol=1e-9)


def test_render_and_decode_by_hand():
    d = np.eye(3, 4)
    atoms = np.array([[0, 2]])
    positions = np.array([[1, 5]])
    values = np.array([[2.0, -1.0]])
    band = ref_mb.render(d, atoms, positions, values, 8)
    np.testing.assert_allclose(band[0], [0, 2, 0, 0, 0, 0, 0, 0])
    np.testing.assert_allclose(band[1], [0, 0, 0, 0, 0, 0, 0, -1])
    # atom 2's one tap lands at 8, past the end: dropped
    assert not ref_mb.render(d, atoms, positions + 1, values, 8)[1].any()
    assert np.isnan(ref_mb.render(d, atoms, positions + 5, values, 8)).all()
    assert ref_mb.decode({8: d}, {8: (atoms, positions, values)}, 8).shape == (2, 8)


def test_precision_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 3.1415926])
    assert ref.round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, 3.140625]
    y = np.array([1.0 + 2.0**-11, 3.1415926])
    assert ref_mb._maybe(y, "float16").tolist() == [1.0, 3.140625]
    assert ref_mb._maybe(y * 1j, "float16").tolist() == [1j, 3.140625j]
    assert ref_mb._maybe(y, "float32").tolist() == [1.0 + 2.0**-11, float(np.float32(3.1415926))]
    assert ref_mb._maybe(y, None) is y
