"""The L0 ops and losses of the splat path in the port against ``mptpu`` on
JAX-CPU, on the same seeded numpy inputs: forward values, and the gradient
of ``sum(out * w)`` for a seeded ``w`` through ``jax.grad`` and
``torch.autograd.grad``.

Tolerance: ``close`` compares with rtol 1e-4 and an atol of 1e-5 times the
largest magnitude of the reference (1e-5 absolute where that is below 1):
both packages compute in float32, FFTs and sums in different orders, so an
element near zero carries the rounding of the largest ones. Tests with
another tolerance say so.
"""

from importlib import import_module

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.gen import transfer as jtransfer
from mptpu.losses import iterative as jiter
from mptpu.losses import multiband_spec as jmb
from mptpu.models.splat_overfit import splat_loss_transform as j_splat_transform
from mptpu_torch.gen import transfer as ttransfer
from mptpu_torch.losses import iterative as titer
from mptpu_torch.losses import multiband_spec as tmb
from mptpu_torch.models.splat_overfit import splat_loss_transform as t_splat_transform

# both packages' ops export functions named pdf and stft over their modules'
jfft, jpdf, jstft, jup, jwin = (import_module(f"mptpu.ops.{name}")
                                for name in ("fft", "pdf", "stft", "upsample", "windows"))
tfft, tpdf, tstft, tup, twin = (import_module(f"mptpu_torch.ops.{name}")
                                for name in ("fft", "pdf", "stft", "upsample", "windows"))

RTOL = 1e-4


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), np.float32)


def uniform(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def close(got, want, rtol=RTOL, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = atol_rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def run_both(jfn, tfn, arrays, grad=True, seed=100):
    """(jax outputs, torch outputs, jax grads, torch grads) of the functions
    on ``arrays``; the gradients are those of sum(out * w) into every
    float array, ``w`` seeded per output."""
    j_in = [jnp.asarray(a) for a in arrays]
    t_in = [torch.from_numpy(a.copy()) for a in arrays]
    jfn = jax.jit(jfn)
    j_out = jfn(*j_in)
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    ws = [normal(np.shape(o), seed + i) for i, o in enumerate(j_outs)]
    result = [[np.asarray(o) for o in j_outs]]
    if grad:
        for t in t_in:
            t.requires_grad_()
    t_out = tfn(*t_in)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    result.append([o.detach().numpy() for o in t_outs])
    if not grad:
        return result + [[], []]

    def j_loss(*xs):
        outs = jfn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs, ws))

    j_g = jax.jit(jax.grad(j_loss, argnums=tuple(range(len(arrays)))))(*j_in)
    t_loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(t_outs, ws))
    t_g = torch.autograd.grad(t_loss, t_in)
    return result + [[np.asarray(g) for g in j_g], [g.numpy() for g in t_g]]


def assert_parity(jfn, tfn, arrays, grad=True, rtol=RTOL, atol_rel=1e-5, grad_atol_rel=None):
    j_o, t_o, j_g, t_g = run_both(jfn, tfn, arrays, grad)
    for a, b in zip(t_o, j_o):
        close(a, b, rtol, atol_rel)
    for a, b in zip(t_g, j_g):
        close(a, b, rtol, atol_rel if grad_atol_rel is None else grad_atol_rel)
    return t_o, t_g


# windows and the grid --------------------------------------------------------

@pytest.mark.parametrize("size", [1, 16, 64, 511, 2048])
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_match_exactly(size, periodic):
    np.testing.assert_array_equal(twin.hann_window(size, periodic, device="cpu").numpy(),
                                  np.asarray(jwin.hann_window(size, periodic)))
    if size > 1:
        np.testing.assert_array_equal(twin.hamming_window(size, periodic, device="cpu").numpy(),
                                      np.asarray(jwin.hamming_window(size, periodic)))


@pytest.mark.parametrize("num", [1, 2, 16, 128, 2049, 4096, 65536])
def test_linspace_against_jnp(num):
    """Exact on a grid from 0 to 1 (the pdf grids and envelopes); elsewhere
    within two float32 places of the larger end (``1 - s`` cancels), the
    ends exact."""
    got = twin.linspace(0.0, 1.0, num, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.linspace(0.0, 1.0, num)))
    for start, stop in ((1.0, 0.0), (1e-12, 20.0)):
        got = twin.linspace(start, stop, num, device="cpu").numpy()
        want = np.asarray(jnp.linspace(start, stop, num))
        eps = np.finfo(np.float32).eps
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * eps * max(abs(start), abs(stop)))
        assert got[0] == want[0] and got[-1] == want[-1]


# complex construction --------------------------------------------------------

def test_cexp_and_to_complex():
    phase = normal((3, 40), 1, 10.0)
    re, im = normal((3, 40), 2), normal((3, 40), 3)

    def as_parts(f):
        return lambda *a: (jnp.real(f(*a)), jnp.imag(f(*a)))

    def as_parts_t(f):
        return lambda *a: (f(*a).real, f(*a).imag)

    assert_parity(as_parts(jfft.cexp), as_parts_t(tfft.cexp), [phase])
    assert_parity(as_parts(jfft.to_complex), as_parts_t(tfft.to_complex), [re, im])


# pdf -------------------------------------------------------------------------

def test_pdf():
    x = uniform((5, 30), 4, 0, 1)
    mean = uniform((5, 1), 5, 0, 1)
    sd = uniform((5, 1), 6, 0.05, 0.5)
    assert_parity(jpdf.pdf, tpdf.pdf, [x, mean, sd])


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n", [129, 2049, 4096])
def test_pdf2(normalize, n):
    means = uniform((2, 6), 7, -0.1, 1.1)
    stds = uniform((2, 6), 8, 0.01, 0.4)
    assert_parity(lambda m, s: jpdf.pdf2(m, s, n, normalize),
                  lambda m, s: tpdf.pdf2(m, s, n, normalize), [means, stds])


def test_pdf2_at_tiny_stds():
    """Stds of 1e-12, as the splat path passes for a zero head output: the
    logpdf form keeps the peak where a grid point is the mean and gives
    exact zeros elsewhere, in both packages."""
    n = 257
    grid = np.linspace(0, 1, n).astype(np.float32)
    means = np.array([[grid[64], grid[200], 0.3337, 1.7]], np.float32)
    stds = np.full(means.shape, 1e-12, np.float32)
    for normalize in (True, False):
        got = tpdf.pdf2(torch.from_numpy(means), torch.from_numpy(stds), n, normalize).numpy()
        want = np.asarray(jpdf.pdf2(jnp.asarray(means), jnp.asarray(stds), n, normalize))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert np.isfinite(got).all()
    # with normalize, a mean on the grid gives a one-hot row, others zeros
    assert np.count_nonzero(got[0, 2:]) == 0
    # gradient into the means at normal stds next to the tiny ones
    stds = np.array([[1e-12, 0.1, 1e-12, 0.2]], np.float32)
    assert_parity(lambda m: jpdf.pdf2(m, jnp.asarray(stds), n),
                  lambda m: tpdf.pdf2(m, torch.from_numpy(stds), n), [means])


@pytest.mark.parametrize("normalize", [True, False])
def test_gamma_pdf(normalize):
    shape = uniform((3, 4), 9, 0.5, 4.0)
    rate = uniform((3, 4), 10, 0.2, 3.0)
    assert_parity(lambda a, b: jpdf.gamma_pdf(a, b, 512, normalize),
                  lambda a, b: tpdf.gamma_pdf(a, b, 512, normalize), [shape, rate],
                  rtol=2e-4)


# upsample --------------------------------------------------------------------

@pytest.mark.parametrize("low,desired", [(8, 32), (5, 16), (16, 16), (3, 64)])
def test_upsample_with_holes(low, desired):
    x = normal((2, 3, low), 11)
    t_o, _ = assert_parity(lambda v: jup.upsample_with_holes(v, desired),
                           lambda v: tup.upsample_with_holes(v, desired), [x])
    assert t_o[0].shape == (2, 3, desired)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("lead", [(3, 2, 4), (2, 2, 3, 2)])
@pytest.mark.parametrize("sizes", [(16, 4096), (7, 50), (32, 8), (1, 9)])
def test_interpolate_last_axis(mode, lead, sizes):
    n, desired = sizes
    x = normal(lead + (n,), 12)
    assert_parity(lambda v: jup.interpolate_last_axis(v, desired, mode),
                  lambda v: tup.interpolate_last_axis(v, desired, mode), [x])


def test_interpolate_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tup.interpolate_last_axis(torch.zeros(2, 4), 8, "cubic")


def test_ensure_last_axis_length():
    x = normal((2, 3, 10), 13)
    for desired in (10, 17):
        assert_parity(lambda v: jup.ensure_last_axis_length(v, desired),
                      lambda v: tup.ensure_last_axis_length(v, desired), [x])
    with pytest.raises(ValueError):
        tup.ensure_last_axis_length(torch.from_numpy(x), 9)


@pytest.mark.parametrize("factor", [2, 4])
def test_fft_upsample(factor):
    x = normal((2, 1, 256), 14)
    assert_parity(lambda v: jup.fft_upsample(v, factor), lambda v: tup.fft_upsample(v, factor), [x])


# stft ------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    dict(),
    dict(pad=True),
    dict(pad=True, log_amplitude=True),
    dict(pad=True, return_complex=True),
    dict(mag_epsilon=1e-3),
    dict(pad=True, log_amplitude=True, log_epsilon=1e-2, mag_epsilon=1e-4),
])
@pytest.mark.parametrize("ws,step", [(64, 16), (512, 256)])
def test_stft(flags, ws, step):
    x = normal((2, 3, 2048), 15)
    t_o, _ = assert_parity(lambda v: jstft.stft(v, ws, step, **flags),
                           lambda v: tstft.stft(v, ws, step, **flags), [x])
    frames = 2048 // step if flags.get("pad") else min(2048 // step, (2048 - ws) // step + 1)
    assert t_o[0].shape[:3] == (2, 3, frames)


def test_log_stft():
    x = normal((1, 2, 1024), 16)
    assert_parity(lambda v: jstft.log_stft(v, 128, 64), lambda v: tstft.log_stft(v, 128, 64), [x])


@pytest.mark.parametrize("pad", [False, True])
def test_stft_relative_phase(pad):
    """Magnitude and the phase differences, forward and gradient. The DC
    and Nyquist coefficients are real, and the sign of their zero imaginary
    part, which the two FFTs may round apart, puts a negative one's phase at
    pi or -pi: the phases are compared modulo 2 pi."""
    x = normal((2, 1, 1024), 17)
    j_o, t_o, j_g, t_g = run_both(lambda v: jstft.stft_relative_phase(v, 128, 64, pad),
                                  lambda v: tstft.stft_relative_phase(v, 128, 64, pad), [x])
    close(t_o[0], j_o[0])
    wrapped = np.angle(np.exp(1j * (t_o[1].astype(np.float64) - j_o[1])))
    np.testing.assert_allclose(wrapped, 0, atol=1e-4)
    close(t_g[0], j_g[0])


def test_short_time_transform():
    x = normal((2, 1, 1024), 18)
    basis = normal((100, 64), 19)
    assert_parity(jstft.short_time_transform, tstft.short_time_transform, [x, basis])


# the bandpass filter, the splat loss's feature, the iterative loss ------------

def test_gaussian_bandpass_filtered():
    """(1, E) means and stds over a (1, 1, n) signal, as the splat's noise,
    and over (1, E, n) signals, as its resonances."""
    means = uniform((1, 6), 20, 0, 1)
    stds = uniform((1, 6), 21, 0.01, 0.3)
    for shape in ((1, 1, 1024), (1, 6, 1024)):
        sig = normal(shape, 22)
        t_o, _ = assert_parity(jtransfer.gaussian_bandpass_filtered,
                               ttransfer.gaussian_bandpass_filtered, [means, stds, sig])
        assert t_o[0].shape == (1, 6, 1024)


def test_multiband_spectrogram_keys_and_values():
    x = normal((1, 2, 4096), 23)
    spec = {"short": (64, 16), "long": (128, 32)}
    got = tmb.multiband_spectrogram(torch.from_numpy(x), spec, 512)
    want = jax.jit(lambda v: jmb.multiband_spectrogram(v, spec, 512))(jnp.asarray(x))
    # mptpu's order (jit returns the dict with sorted keys)
    assert list(got) == [f"{b}_{n}" for n in spec for b in (512, 1024, 2048, 4096)]
    assert set(want) == set(got)
    for k in want:
        close(got[k].numpy(), np.asarray(want[k]))
    normed = tmb.multiband_spectrogram(torch.from_numpy(x), spec, 512, normalize=True)
    close(normed["1024_long"].numpy(), np.asarray(want["1024_long"]) / (2 * 1024))


@pytest.mark.parametrize("n", [1024, 4096])
def test_splat_loss_transform(n):
    """flattened_multiband_spectrogram with the splat loss's spec, forward
    and gradient, over several channels."""
    x = normal((1, 3, n), 24)
    t_o, _ = assert_parity(j_splat_transform, t_splat_transform, [x])
    bands = [s for s in (512, 1024, 2048, 4096) if s <= n]
    assert t_o[0].shape == (1, 3, sum((s // 16) * 33 for s in bands))


def test_stft_transform():
    x = normal((2, 1, 4096), 25)
    assert_parity(lambda v: jmb.stft_transform(v, 512, 128),
                  lambda v: tmb.stft_transform(v, 512, 128), [x])


def channel_inputs(n_events=6, n=1024, seed=26):
    """A target and events whose transformed l1 norms are far apart (no
    ties in the sort)."""
    target = normal((2, 1, n), seed)
    scales = np.array([1.0, 0.2, 3.0, 0.6, 1.7, 0.05, 2.4, 0.9][:n_events], np.float32)
    recon = normal((2, n_events, n), seed + 1) * scales[None, :, None]
    return target, recon


def test_sort_channels_descending_norm():
    _, recon = channel_inputs()
    x = np.abs(recon[..., :50])
    norms = x.sum(-1)
    assert len(np.unique(norms)) == norms.size
    assert_parity(jiter.sort_channels_descending_norm, titer.sort_channels_descending_norm, [x])


def test_sort_channels_ties_reverse_order():
    """Equal norms: jnp's stable ascending sort, reversed, puts the later
    channel first; so does the port."""
    x = np.array([[[1.0, 0.0], [0.0, 1.0], [2.0, 0.0]]], np.float32)
    got = titer.sort_channels_descending_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jiter.sort_channels_descending_norm(jnp.asarray(x))))
    np.testing.assert_array_equal(got[0, 1:], x[0, [1, 0]])


@pytest.mark.parametrize("sort_channels", [True, False])
@pytest.mark.parametrize("ratio_loss", [False, True])
def test_iterative_loss(sort_channels, ratio_loss):
    target, recon = channel_inputs()
    kw = dict(ratio_loss=ratio_loss, sort_channels=sort_channels)
    assert_parity(lambda t, r: jiter.iterative_loss(t, r, j_splat_transform, **kw),
                  lambda t, r: titer.iterative_loss(t, r, t_splat_transform, **kw),
                  [target, recon])


def test_iterative_loss_residual():
    target, recon = channel_inputs()
    assert_parity(
        lambda t, r: jiter.iterative_loss(t, r, j_splat_transform, return_residual=True),
        lambda t, r: titer.iterative_loss(t, r, t_splat_transform, return_residual=True),
        [target, recon])


def test_band_ends_are_real_before_the_inverse():
    """fft_frequency_decompose hands each band's inverse FFT a spectrum
    whose first and last imaginary parts are 0 (a band's last coefficient
    lies inside the full spectrum); pocketfft ignores them anyway, so on
    the CPU the bands are the plain irfft's, bit for bit."""
    from mptpu_torch.ops.decompose import _real_ends, fft_frequency_decompose

    spec = torch.from_numpy(normal((2, 9), 70) + 1j * normal((2, 9), 71)).to(torch.complex64)
    ends = _real_ends(spec)
    np.testing.assert_array_equal(ends.real.numpy(), spec.real.numpy())
    np.testing.assert_array_equal(ends.imag[:, 1:-1].numpy(), spec.imag[:, 1:-1].numpy())
    assert not ends.imag[:, [0, -1]].any()
    x = torch.from_numpy(normal((1, 2, 2048), 72))
    coeffs = torch.fft.rfft(x, norm="ortho")
    bands = fft_frequency_decompose(x, 512)
    for size, band in bands.items():
        sl = coeffs[..., : size // 2 + 1].clone()
        if size > 512:
            sl[..., : size // 4] = 0
        np.testing.assert_array_equal(band.numpy(),
                                      torch.fft.irfft(sl, n=size, norm="ortho").numpy())
