"""mptpu_torch.ops against mptpu.ops on the same numpy inputs (JAX on the
CPU, the port on device="cpu").

Tolerances: norms are short float32 reductions (rtol 1e-6); convolution
and FFT outputs are sums taken in another order by XLA and by torch
(rtol 1e-5 / atol 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mptpu import ops as jops
from mptpu_torch import ops as tops

RNG = np.random.default_rng(11)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_TOL = dict(rtol=1e-6, atol=1e-7)


def both(fn_name, *arrays, **kw):
    j = getattr(jops, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    t = getattr(tops, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return j, t


def close(j, t, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize(
    "fn_name,shape,kw",
    [
        ("unit_norm", (6, 32), {}),
        ("unit_norm", (3, 4, 32), dict(axis=1)),
        ("max_norm", (6, 32), {}),
        ("limit_norm", (2, 3, 40), {}),
        ("example_norm", (2, 3, 40), {}),
    ],
)
def test_norms_match_mptpu(fn_name, shape, kw):
    x = (RNG.standard_normal(shape) * 3).astype(np.float32)
    j, t = both(fn_name, x, **kw)
    close(j, t, NORM_TOL)


def test_max_norm_return_value_and_zero_row():
    x = RNG.standard_normal((4, 16)).astype(np.float32)
    x[1] = 0.0
    (jn, jv), (tn, tv) = both("max_norm", x, return_value=True)
    close(jn, tn, NORM_TOL)
    close(jv, tv, NORM_TOL)
    # the clamp keeps the all-zero row finite
    j, t = both("unit_norm", x)
    assert torch.isfinite(t).all()
    close(j, t, NORM_TOL)


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_fft_convolve_matches_mptpu(norm):
    a = RNG.standard_normal((2, 3, 256)).astype(np.float32)
    b = RNG.standard_normal((2, 3, 256)).astype(np.float32)
    c = RNG.standard_normal((1, 3, 256)).astype(np.float32)
    j, t = both("fft_convolve", a, b, c, norm=norm)
    # FFT round-off scales with the largest output, not with each element
    close(j, t, dict(rtol=1e-5, atol=1e-6 * float(np.abs(np.asarray(j)).max())))


def test_simple_fft_convolve_and_helpers_match_mptpu():
    a = RNG.standard_normal((3, 300)).astype(np.float32)
    b = RNG.standard_normal((3, 300)).astype(np.float32)
    j, t = both("simple_fft_convolve", a, b)
    close(j, t, CONV_TOL)
    for n in (1, 2, 3, 511, 512, 513, 16896):
        assert tops.next_pow2(n) == jops.next_pow2(n)
        assert tops.n_fft_coeffs(n) == jops.n_fft_coeffs(n)


@pytest.mark.parametrize(
    "mode",
    [dict(), dict(use_fft=True), dict(approx=slice(0, 300)), dict(approx=64)],
    ids=["conv", "fft", "approx_slice", "approx_topk"],
)
def test_mp_correlate_modes_match_mptpu(mode):
    sig = RNG.standard_normal((2, 1, 1024)).astype(np.float32)
    d = RNG.standard_normal((16, 128)).astype(np.float32)
    j, t = both("mp_correlate", sig, d, **mode)
    assert t.shape == (2, 16, 1024)
    close(j, t, CONV_TOL)


def test_torch_style_conv_multichannel_matches_mptpu():
    sig = RNG.standard_normal((2, 2, 512)).astype(np.float32)
    d = RNG.standard_normal((8, 2, 64)).astype(np.float32)
    j, t = both("torch_style_conv", sig, d)
    close(j, t, CONV_TOL)
