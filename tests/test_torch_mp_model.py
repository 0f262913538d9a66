"""The learned-atom matching pursuit (``mptpu/models/mp_model.py``) in the
port against ``mptpu`` on JAX-CPU, at ``tests/test_models_extra.py``'s
shapes (8 atoms x 32 taps, 512 samples, 3 iterations), ``mptpu``'s
initial atoms carried by ``convert.module_from_flax``: the forward, the
value and gradient of ``iterative_loss`` over ``stft(x, 128, 64,
pad=True)``, and 8 Adam steps (lr 1e-2) against optax's trajectory.

Tolerances: atom and time indices identical; channels within 1e-5 of
their largest; gradients within 1e-5 of their largest (measured 1.6e-7;
float32 against float64 in the port 3e-7); the loss, a telescoping
difference of l1 norms, within 1e-6 of the target feature's l1 norm
(a step's loss differs by 1.9e-6 absolute, 1e-3 relative); the atoms
within 1e-5 absolute of optax's after each step, a thousandth of lr
(measured 5.1e-7 after 8).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.losses import iterative_loss as j_iterative_loss
from mptpu.models import MatchingPursuit as JMP
from mptpu.ops import fft_convolve as j_fft_convolve
from mptpu.ops import stft as j_stft
from mptpu.sparse import sparsify2 as j_sparsify2
from mptpu_torch import convert
from mptpu_torch.losses import iterative_loss as t_iterative_loss
from mptpu_torch.models import MatchingPursuit as TMP
from mptpu_torch.ops import stft as t_stft

SHAPE = dict(n_atoms=8, atom_samples=32, n_samples=512, n_iterations=3)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work (the suite may run in
    six test processes on one machine)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def carried():
    """mptpu's model, its initial parameters, the port's model carrying
    them, and test_models_extra.py's audio."""
    jm = JMP(**SHAPE)
    audio = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 1, 512)) * 0.1)
    params = jm.init(KEY, jnp.asarray(audio))
    tm = convert.module_from_flax(TMP(*SHAPE.values(), device="cpu"), params)
    return jm, params, tm, audio


def j_transform(x):
    return j_stft(x, 128, 64, pad=True)


def t_transform(x):
    return t_stft(x, 128, 64, pad=True)


def feature_norm(audio):
    return float(jnp.sum(jnp.abs(j_transform(jnp.asarray(audio)))))


def j_events(params, audio):
    """Each iteration's atom and time in mptpu's own step (mp_model.py:44-49)."""
    atoms = params["params"]["atoms"]
    na = jnp.pad(atoms, ((0, 0), (0, 0), (0, SHAPE["n_samples"] - SHAPE["atom_samples"])))
    residual, picks = jnp.asarray(audio), []
    for _ in range(SHAPE["n_iterations"]):
        _, time, atom = j_sparsify2(j_fft_convolve(residual, na), n_to_keep=1)
        picks.append((int(jnp.argmax(jnp.abs(atom[0, 0]))), int(jnp.argmax(jnp.abs(time[0, 0])))))
        residual = residual - j_fft_convolve(atom @ na, time)
    return picks


def test_parameters_carry_and_refuse_a_bad_shape(carried):
    _, params, tm, _ = carried
    np.testing.assert_array_equal(tm.atoms.detach().numpy(), np.asarray(params["params"]["atoms"]))
    with pytest.raises(ValueError, match="atoms"):
        convert.module_from_flax(TMP(8, 16, 512, 3, device="cpu"), params)


def test_forward(carried):
    """Channels (1, 3, 512) within 1e-5 of their largest; every
    iteration's atom and time mptpu's."""
    jm, params, tm, audio = carried
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(audio)))
    with torch.no_grad():
        got, atoms, times = tm(torch.from_numpy(audio), return_events=True)
    assert got.shape == want.shape == (1, 3, 512)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert list(zip(atoms[0].tolist(), times[0].tolist())) == j_events(params, audio)


def test_value_and_grad(carried):
    """iterative_loss of the channels and its gradient into the atoms."""
    jm, params, tm, audio = carried

    def j_loss(p):
        return j_iterative_loss(jnp.asarray(audio), jm.apply(p, jnp.asarray(audio)), j_transform)

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss))(params)
    a = torch.from_numpy(audio)
    loss = t_iterative_loss(a, tm(a), t_transform)
    (g,) = torch.autograd.grad(loss, [tm.atoms])
    want = np.asarray(j_g["params"]["atoms"])
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=0,
                               atol=1e-6 * feature_norm(audio))
    assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_eight_adam_steps_against_optax(carried):
    """tests/test_models_extra.py's training loop (optax.adam(1e-2), 8
    jitted steps) against torch.optim.Adam on the port: each step's loss
    and the atoms after it; the loss falls."""
    jm, params, _, audio = carried
    tm = convert.module_from_flax(TMP(*SHAPE.values(), device="cpu"), params)

    def j_loss(p):
        return j_iterative_loss(jnp.asarray(audio), jm.apply(p, jnp.asarray(audio)), j_transform)

    opt = optax.adam(1e-2)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(j_loss)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    t_opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    a = torch.from_numpy(audio)
    atol = 1e-6 * feature_norm(audio)
    losses = []
    for _ in range(8):
        params, state, j_val = step(params, state)
        t_opt.zero_grad()
        loss = t_iterative_loss(a, tm(a), t_transform)
        loss.backward()
        t_opt.step()
        np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=0, atol=atol)
        np.testing.assert_allclose(tm.atoms.detach().numpy(), np.asarray(params["params"]["atoms"]),
                                   rtol=0, atol=1e-5)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
