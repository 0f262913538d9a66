"""mptpu_torch.ops.ste against mptpu.ops.ste on the same numpy inputs (JAX
on the CPU, the port on CPU tensors): forward values and the gradient of
``sum(out * w)`` for a seeded weight ``w``, through ``jax.grad`` and
``torch.autograd.grad``.

Tolerance: values and gradients rtol 1e-4 / atol 1e-5. Inputs are seeded
normals: no exact ties for an argmax, and nothing exactly on a clamp
bound, where ``jnp.clip`` and ``torch.clamp`` may differ.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.ops import ste as jste
from mptpu_torch.ops import ste as tste

TOL = dict(rtol=1e-4, atol=1e-5)


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_out_and_grad(fn, x, w):
    out = fn(jnp.asarray(x))
    g = jax.grad(lambda v: jnp.sum(fn(v) * jnp.asarray(w)))(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def torch_out_and_grad(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    return out.detach().numpy(), g.numpy()


def assert_matches(jfn, tfn, x, seed=0):
    w = normal(x.shape, seed + 100)
    j_out, j_g = jax_out_and_grad(jfn, x, w)
    t_out, t_g = torch_out_and_grad(tfn, x, w)
    np.testing.assert_allclose(t_out, j_out, **TOL)
    np.testing.assert_allclose(t_g, j_g, **TOL)
    return t_out, t_g


def test_soft_dirac_forward_is_one_hot():
    x = normal((4, 16), 0)
    out = tste.soft_dirac(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jste.soft_dirac(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(out.sum(axis=-1), 1.0, rtol=1e-5)
    assert ((out == 0) | np.isclose(out, 1.0)).all()
    assert (np.argmax(out, -1) == np.argmax(x, -1)).all()


def test_soft_dirac_backward_is_softmax_grad():
    x = normal((8,), 1)
    w = np.arange(8, dtype=np.float32)
    _, j_g = jax_out_and_grad(jste.soft_dirac, x, w)
    _, t_g = torch_out_and_grad(tste.soft_dirac, x, w)
    _, soft_g = torch_out_and_grad(lambda v: torch.softmax(v, dim=-1), x, w)
    np.testing.assert_allclose(t_g, j_g, **TOL)
    np.testing.assert_allclose(t_g, soft_g, rtol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_sparse_softmax_values(normalize):
    x = normal((3, 10), 2)
    out, _ = assert_matches(lambda v: jste.sparse_softmax(v, normalize=normalize),
                            lambda v: tste.sparse_softmax(v, normalize=normalize), x)
    # exactly one non-zero per row: the largest probability, or 1
    assert (np.count_nonzero(out, axis=-1) == 1).all()
    want = 1.0 if normalize else torch.softmax(torch.from_numpy(x), -1).amax(-1).numpy()
    np.testing.assert_allclose(out.max(axis=-1), want, rtol=1e-5)


def test_soft_clamp_and_step():
    x = np.asarray([-0.5, 0.25, 1.5], np.float32)   # off the bounds 0 and 1
    clamp, g = assert_matches(jste.soft_clamp, tste.soft_clamp, x)
    np.testing.assert_allclose(clamp, [0.0, 0.25, 1.0])
    w = np.full(3, 3.0, np.float32)
    np.testing.assert_allclose(torch_out_and_grad(tste.soft_clamp, x, w)[1], 3.0)
    step, g = assert_matches(jste.step_func, tste.step_func, x)
    np.testing.assert_allclose(step, [-1.0, 1.0, 1.0])


@pytest.mark.parametrize("invert,tau", [(False, 1.0), (True, 1.0), (False, 0.1)])
def test_hard_softmax_one_hot(invert, tau):
    """mptpu's draws fed to the port: forward and backward equal; the
    public function one-hot and fixed by its generator's seed."""
    key = jax.random.PRNGKey(7)
    x = normal((5, 12), 3)
    u = np.array(jax.random.uniform(key, x.shape, minval=1e-20, maxval=1.0))
    out, _ = assert_matches(
        lambda v: jste.hard_softmax(key, v, invert=invert, tau=tau),
        lambda v: tste._hard_softmax_from_uniform(v, torch.from_numpy(u), invert=invert, tau=tau),
        x,
    )
    np.testing.assert_allclose(out.sum(axis=-1), 1.0, rtol=1e-5)
    assert (np.count_nonzero(out, axis=-1) == 1).all()

    xt = torch.from_numpy(x)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tste.hard_softmax(xt, invert=invert, tau=tau, generator=gen)

    a, b = draw(0), draw(0)
    assert torch.equal(a, b)
    assert (torch.count_nonzero(a, dim=-1) == 1).all()
    assert torch.allclose(a.sum(-1), torch.ones(5))
    assert any(not torch.equal(draw(0), draw(s)) for s in range(1, 6))


CASES = {
    "straight_through": (lambda v: jste.straight_through(jnp.sign(v) * v**2, 2.0 * v),
                         lambda v: tste.straight_through(torch.sign(v) * v**2, 2.0 * v)),
    "leaky_relu_ste": (jste.leaky_relu_ste, tste.leaky_relu_ste),
    "leaky_relu_ste_slope": (lambda v: jste.leaky_relu_ste(v, 0.2),
                             lambda v: tste.leaky_relu_ste(v, 0.2)),
    "sparse_softmax_axis0": (lambda v: jste.sparse_softmax(v, axis=0),
                             lambda v: tste.sparse_softmax(v, axis=0)),
    "soft_dirac_axis0": (lambda v: jste.soft_dirac(v, axis=0),
                         lambda v: tste.soft_dirac(v, axis=0)),
    "soft_clamp": (jste.soft_clamp, tste.soft_clamp),
    "step_func": (jste.step_func, tste.step_func),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ste_forward_and_gradient_match_mptpu(name):
    jfn, tfn = CASES[name]
    x = 1.5 * normal((6, 9), 4)
    assert_matches(jfn, tfn, x, seed=5)
