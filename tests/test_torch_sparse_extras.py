"""The rest of mptpu_torch.sparse.matching_pursuit (feature map, sparse
coding loss and its stateful form, AtomPlacement, flatten_atom_dict), the
OMP refit and refit_gains, against mptpu on the same numpy inputs (JAX on
the CPU, the port on CPU tensors).

Tolerances, as tests/test_fast_mp.py: events identical; values rtol 1e-4
/ atol 1e-5; residuals rtol 1e-3 / atol 1e-5; refit values rtol 1e-3
(the normal equations of overlapping events round differently in the two
solvers). Gradients: rtol 1e-4 and atol 1e-5 times the largest magnitude
of mptpu's gradient. Signals are planted atom sums where an argmax decides
(tests/test_torch_mp.py:planted), so that no near-tie flips an event.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu import sparse as jsp
from mptpu.ops.refit import refit_gains as j_refit_gains
from mptpu_torch import sparse as tsp
from mptpu_torch.ops import refit_gains
from test_torch_mp import planted

VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
RESIDUAL_TOL = dict(rtol=1e-3, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def assert_events(j, tr):
    np.testing.assert_array_equal(tr.atom_indices.numpy(), np.asarray(j.atom_indices))
    np.testing.assert_array_equal(tr.positions.numpy(), np.asarray(j.positions))


def _dict(n_atoms=8, atom_size=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n_atoms, atom_size)).astype(np.float32)


def _signal_from_atoms(d, placements, amps, n_samples):
    """tests/test_matching_pursuit.py:_signal_from_atoms: unit-normed atoms
    at the given (atom, position) pairs."""
    du = d / np.linalg.norm(d, axis=-1, keepdims=True)
    sig = np.zeros((1, 1, n_samples), np.float32)
    for (a, p), amp in zip(placements, amps):
        sig[0, 0, p : p + d.shape[-1]] += amp * du[a]
    return sig


class TestFeatureMap:
    def test_feature_map_entries(self):
        d = _dict()
        sig = _signal_from_atoms(d, [(1, 30)], [2.0], 128)
        fm = tsp.sparse_feature_map(t(sig), t(d), n_steps=1).numpy()
        np.testing.assert_allclose(fm, np.asarray(jsp.sparse_feature_map(sig, d, n_steps=1)),
                                   **VALUE_TOL)
        assert fm.shape == (1, 8, 128)
        assert abs(float(fm[0, 1, 30]) - 2.0) < 1e-3
        assert np.count_nonzero(fm) == 1

    @pytest.mark.parametrize("d_shape", [(16, 64), (8, 2, 64)], ids=["mono", "two_channel"])
    def test_feature_map_and_gradient_match_mptpu(self, d_shape):
        """Forward with the residual; the gradient of sum(fm * w) into the
        signal and the dictionary (through the unit norm, the picked
        correlations and the residual subtractions)."""
        rng = np.random.default_rng(1)
        d = rng.standard_normal(d_shape).astype(np.float32)
        sig = planted(d, 2, 512, seed=3)
        w = rng.standard_normal((2, d_shape[0], 512)).astype(np.float32)
        j_fm, j_res = jsp.sparse_feature_map(sig, d, n_steps=8, return_residual=True)
        j_gs, j_gd = jax.grad(
            lambda s, dd: jnp.sum(jsp.sparse_feature_map(s, dd, n_steps=8) * w), argnums=(0, 1)
        )(jnp.asarray(sig), jnp.asarray(d))
        st, dt = t(sig).requires_grad_(), t(d).requires_grad_()
        fm, res = tsp.sparse_feature_map(st, dt, n_steps=8, return_residual=True)
        np.testing.assert_array_equal(fm.detach().numpy() != 0, np.asarray(j_fm) != 0)
        np.testing.assert_allclose(fm.detach().numpy(), np.asarray(j_fm), **VALUE_TOL)
        np.testing.assert_allclose(res.detach().numpy(), np.asarray(j_res), **RESIDUAL_TOL)
        gs, gd = torch.autograd.grad((fm * t(w)).sum(), (st, dt))
        assert_grad_close(gs.numpy(), j_gs)
        assert_grad_close(gd.numpy(), j_gd)

    def test_feature_map_nonzeros_are_the_greedy_events(self):
        d = _dict(16, 64, seed=2)
        sig = planted(d, 3, 1024, seed=4)
        fm = tsp.sparse_feature_map(t(sig), t(d), n_steps=9)
        code = tsp.sparse_code(t(sig), t(d), n_steps=9)
        b = torch.arange(3).expand(9, 3)
        picked = torch.zeros_like(fm).index_put_(   # a repeated event adds to itself
            (b, code.atom_indices.long(), code.positions.long()), code.values, accumulate=True)
        assert torch.equal(fm, picked)

    def test_feature_map_backward_keeps_no_map(self):
        """Only index and shape are saved for the pick of each step's value:
        no tensor of the (batch, n_atoms, n_samples) map's size is kept for
        the backward (torch.gather would keep one per step)."""
        d = _dict(16, 128, seed=5)
        sig = planted(d, 2, 1024, seed=6)
        saved = []

        def pack(x):
            saved.append(x.numel())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            fm = tsp.sparse_feature_map(t(sig), t(d).requires_grad_(), n_steps=8)
        assert max(saved) < fm.numel() // 4, sorted(saved)[-5:]


class TestSparseCodingLoss:
    @pytest.mark.parametrize("case", ["differ", "same"])
    def test_loss_and_gradient_match_mptpu(self, case):
        """The gradient into ``recon``; with ``recon == target`` the two
        maps tie at their maximum (half the gradient to each side in both
        frameworks) and the target's largest entry sits exactly on its clip
        bound, which the port clips as jnp.clip does."""
        rng = np.random.default_rng(0)
        d = rng.standard_normal((16, 64)).astype(np.float32)
        sig = planted(d, 2, 512, seed=3)
        noise = 0.01 * np.sqrt((sig**2).mean()) * rng.standard_normal(sig.shape)
        recon = sig + noise.astype(np.float32) if case == "differ" else sig.copy()
        j_loss, j_g = jax.value_and_grad(
            lambda r: jsp.sparse_coding_loss(r, jnp.asarray(sig), jnp.asarray(d), n_steps=8)
        )(jnp.asarray(recon))
        rt = t(recon).requires_grad_()
        loss = tsp.sparse_coding_loss(rt, t(sig), t(d), n_steps=8)
        (g,) = torch.autograd.grad(loss, rt)
        np.testing.assert_allclose(loss.item(), float(j_loss), **VALUE_TOL)
        assert_grad_close(g.numpy(), j_g)

    def test_sparse_coding_loss_zero_for_identical(self):
        rng = np.random.default_rng(7)
        d = _dict()
        sig = rng.standard_normal((1, 1, 128)).astype(np.float32)
        other = rng.standard_normal((1, 1, 128)).astype(np.float32)
        same = float(tsp.sparse_coding_loss(t(sig), t(sig), t(d), n_steps=3))
        diff = float(tsp.sparse_coding_loss(t(other), t(sig), t(d), n_steps=3))
        np.testing.assert_allclose(same, float(jsp.sparse_coding_loss(sig, sig, d, n_steps=3)),
                                   **VALUE_TOL)
        np.testing.assert_allclose(diff, float(jsp.sparse_coding_loss(other, sig, d, n_steps=3)),
                                   **VALUE_TOL)
        assert same < diff

    def test_sparse_coding_loss_stateful(self):
        """tests/test_inventory_extras.py:126 with mptpu's initial dictionary
        carried across: the dictionary after each learning call and every
        loss as mptpu's."""
        rng = np.random.default_rng(0)
        target = rng.standard_normal((1, 1, 512)).astype(np.float32)
        recon = rng.standard_normal((1, 1, 512)).astype(np.float32)
        j = jsp.SparseCodingLoss(n_atoms=8, atom_size=32, n_steps=4, learning_steps=2)
        scl = tsp.SparseCodingLoss(n_atoms=8, atom_size=32, n_steps=4, learning_steps=2,
                                   device="cpu")
        assert scl.d.shape == (8, 32) and scl.d.device.type == "cpu"
        np.testing.assert_allclose(scl.d.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
        scl.d = t(j.d)
        losses = []
        for executed in (1, 2, 2):
            got = scl.loss(t(recon), t(target))
            want = j.loss(recon, target)
            assert scl._steps_executed == executed == j._steps_executed
            np.testing.assert_allclose(scl.d.numpy(), np.asarray(j.d), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(float(got), float(want), **VALUE_TOL)
            losses.append(float(got))
        assert np.isfinite(losses).all()
        assert float(scl.loss(t(target), t(target))) < losses[-1]

    def test_initial_dictionary_follows_the_generator(self):
        def d(seed):
            return tsp.SparseCodingLoss(8, 32, 4, generator=torch.Generator().manual_seed(seed),
                                        device="cpu").d

        assert torch.equal(d(3), d(3)) and not torch.equal(d(3), d(4))
        assert torch.equal(tsp.SparseCodingLoss(8, 32, 4, device="cpu").d, d(0))


class TestAtomPlacement:
    def test_atom_placement(self):
        """tests/test_inventory_extras.py:107, plus a second row of events
        past the end and at negative indices: lax.dynamic_slice counts a
        negative start from the end of the 2 x n_samples buffer and clamps
        every start into [0, n_samples], so times 288 (past the end) and
        -32 (480) land at 256, wholly in the dropped half, and -320 at 192."""
        n_samples, n_events, step = 256, 3, 32
        ap = tsp.AtomPlacement(n_samples, n_events, step)
        x = np.zeros((2, n_events, n_samples), np.float32)
        x[:, 0, :4] = 1.0
        x[:, 1, :4] = 2.0
        x[:, 2, :4] = 3.0
        x[1] += np.random.default_rng(8).standard_normal((n_events, n_samples)).astype(np.float32)
        idx = np.asarray([[0, 2, 7], [9, -1, -10]], dtype=np.int32)
        out = ap.render(t(x), t(idx)).numpy()
        want = np.asarray(jsp.AtomPlacement(n_samples, n_events, step).render(x, idx))
        np.testing.assert_array_equal(out, want)
        assert out.shape == (2, 1, n_samples)
        assert np.allclose(out[0, 0, 0:4], 1.0)
        assert np.allclose(out[0, 0, 64:68], 2.0)
        assert np.allclose(out[0, 0, 224:228], 3.0)
        assert np.abs(out[0]).sum() == 4 * (1 + 2 + 3)
        np.testing.assert_array_equal(out[1, 0], np.pad(x[1, 2], (192, 0))[:n_samples])

    def test_atom_placement_gradient_matches_mptpu(self):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, 4, 128)).astype(np.float32)
        w = rng.standard_normal((2, 1, 128)).astype(np.float32)
        idx = np.asarray([[0, 1, 3, 5], [2, 2, 7, 1]], dtype=np.int32)
        ap = jsp.AtomPlacement(128, 4, 16)
        j_g = jax.grad(lambda v: jnp.sum(ap.render(v, idx) * w))(jnp.asarray(x))
        xt = t(x).requires_grad_()
        out = tsp.AtomPlacement(128, 4, 16)(xt, t(idx))
        (g,) = torch.autograd.grad((out * t(w)).sum(), xt)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j_g))


def test_flatten_atom_dict():
    d = {0: [1, 2], 3: [4], 7: []}
    assert tsp.flatten_atom_dict(d) == jsp.flatten_atom_dict(d) == [1, 2, 4]


@pytest.mark.parametrize("span", [None, 300])
def test_refit_gains_and_gradient_match_mptpu(span):
    rng = np.random.default_rng(10)
    target = rng.standard_normal((2, 1, 512)).astype(np.float32)
    channels = rng.standard_normal((2, 6, 512)).astype(np.float32)
    w = rng.standard_normal((2, 6)).astype(np.float32)

    def j_fn(tg, ch):
        return jnp.sum(j_refit_gains(tg, ch, ridge=1e-3, span=span) * w)

    want = j_refit_gains(target, channels, ridge=1e-3, span=span)
    j_gt, j_gc = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(target), jnp.asarray(channels))
    tt, ct = t(target).requires_grad_(), t(channels).requires_grad_()
    gains = refit_gains(tt, ct, ridge=1e-3, span=span)
    np.testing.assert_allclose(gains.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)
    gt, gc = torch.autograd.grad((gains * t(w)).sum(), (tt, ct))
    np.testing.assert_allclose(gt.numpy(), np.asarray(j_gt), rtol=1e-3,
                               atol=1e-5 * float(np.abs(j_gt).max()))
    np.testing.assert_allclose(gc.numpy(), np.asarray(j_gc), rtol=1e-3,
                               atol=1e-5 * float(np.abs(j_gc).max()))


class TestOMPRefit:
    def test_refit_never_increases_residual(self):
        """tests/test_matching_pursuit.py:224, each framework refitting its
        own greedy code: events as mptpu's, values within rtol 1e-3, the
        waveform error at most the greedy one's, the residual consistent."""
        rng = np.random.default_rng(0)
        d = rng.standard_normal((16, 64)).astype(np.float32)
        sig = rng.standard_normal((2, 1, 1024)).astype(np.float32)
        j_greedy = jsp.sparse_code(sig, d, n_steps=12)
        j_refit = jsp.omp_refit(sig, j_greedy, d, ridge=1e-9)
        greedy = tsp.sparse_code(t(sig), t(d), n_steps=12)
        refit = tsp.omp_refit(t(sig), greedy, t(d), ridge=1e-9)
        assert_events(j_greedy, greedy)
        assert_events(j_refit, refit)
        assert torch.equal(refit.atom_indices, greedy.atom_indices)
        assert torch.equal(refit.positions, greedy.positions)
        np.testing.assert_allclose(refit.values.numpy(), np.asarray(j_refit.values), rtol=1e-3,
                                   atol=1e-5)
        recon = tsp.reconstruct_from_events(refit, t(d))
        g_err = float(((t(sig) - tsp.reconstruct_from_events(greedy, t(d))) ** 2).sum())
        r_err = float(((t(sig) - recon) ** 2).sum())
        assert np.isfinite(r_err) and r_err <= g_err * (1 + 1e-5), (r_err, g_err)
        np.testing.assert_allclose(refit.residual.numpy(), (t(sig) - recon).numpy(), rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(refit.residual.numpy(), np.asarray(j_refit.residual),
                                   **RESIDUAL_TOL)

    def test_exactly_representable_signal_recovers_amplitudes(self):
        """tests/test_matching_pursuit.py:247: the true support with wrong
        amplitudes refits to the true amplitudes."""
        d = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
        idx = np.asarray([[0], [3], [6]], np.int32)
        pos = np.asarray([[10], [200], [400]], np.int32)
        val = np.asarray([[2.0], [-1.5], [0.7]], np.float32)
        dn = tsp.matching_pursuit._normalize_dict(t(d)[:, None, :])
        sig = tsp.scatter_events(t(idx), t(pos), t(val), dn, 512)
        wrong = tsp.SparseCodeResult(t(idx), t(pos), torch.ones(3, 1), sig)
        refit = tsp.omp_refit(sig, wrong, t(d), ridge=1e-12)
        j_wrong = jsp.SparseCodeResult(idx, pos, np.ones((3, 1), np.float32), sig.numpy())
        j_refit = jsp.omp_refit(sig.numpy(), j_wrong, d, ridge=1e-12)
        np.testing.assert_allclose(refit.values.numpy(), val, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(refit.values.numpy(), np.asarray(j_refit.values), rtol=1e-3,
                                   atol=1e-5)
        assert float(refit.residual.norm()) < 1e-3

    def test_event_tracks_match_mptpu(self):
        rng = np.random.default_rng(11)
        d = rng.standard_normal((8, 32)).astype(np.float32)
        idx = rng.integers(0, 8, (5, 3)).astype(np.int32)
        pos = rng.integers(0, 200, (5, 3)).astype(np.int32)   # some run past the end
        res = np.zeros((3, 1, 200), np.float32)
        code = jsp.SparseCodeResult(idx, pos, np.ones((5, 3), np.float32), res)
        want = np.asarray(jsp.event_tracks(code, d, 200))
        got = tsp.event_tracks(tsp.SparseCodeResult(*(t(a) for a in code)), t(d), 200)
        assert got.shape == (3, 5, 200)
        np.testing.assert_allclose(got.numpy(), want, **VALUE_TOL)

    def test_refit_rejects_multichannel(self):
        code = tsp.SparseCodeResult(torch.zeros(1, 1, dtype=torch.int32),
                                    torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, 1),
                                    torch.zeros(1, 2, 64))
        with pytest.raises(ValueError, match="single-channel"):
            tsp.omp_refit(torch.zeros(1, 2, 64), code, torch.ones(4, 2, 8))
