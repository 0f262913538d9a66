"""The perceptual stack and ``Experiment`` (ROADMAP A5) in the port against
``mptpu`` on JAX-CPU: ``perceptual/{gammatone,filterbank,aim,feature,
scattering,psychoacoustic,texture}.py`` and ``config/experiment.py``, at
the sizes of ``tests/test_perceptual_obs.py`` and
``tests/test_inventory_extras.py``. Inputs are numpy draws from a seed;
each gradient is the vector-Jacobian product with one seeded cotangent,
``jax.vjp`` against ``torch.autograd.grad``.

Tolerances: the banks bit for bit; forwards rtol 1e-5 / atol 1e-6, where
an output made by FFTs or long convolutions is held at atol 1e-6 of its
peak (its small entries are float32 rounding of its large ones, as in
``test_torch_layers.py``); gradients within 1e-4 of each tensor's largest
magnitude. The pooling and ``abs`` sites are fed inputs with exact zeros
(a rectified bank is full of them) and ties.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.config.experiment import Experiment as JExperiment
from mptpu.perceptual import aim as jaim
from mptpu.perceptual import feature as jfeat
from mptpu.perceptual import filterbank as jfb
from mptpu.perceptual import gammatone as jgt
from mptpu.perceptual import psychoacoustic as jpa
from mptpu.perceptual import scattering as jsc
from mptpu.perceptual import texture as jtex
from mptpu_torch.config import Experiment
from mptpu_torch.perceptual import aim, feature, filterbank, gammatone, psychoacoustic
from mptpu_torch.perceptual import scattering, texture

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work (the suite may run in
    six test processes on one machine)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(port, want, to_peak=False):
    want = np.asarray(want)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == want.shape
    atol = 1e-6 * np.abs(want).max() if to_peak else FWD["atol"]
    np.testing.assert_allclose(port, want, rtol=FWD["rtol"], atol=atol)


def leaf_close(port, want, where=""):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


def vjp_close(jfn, tfn, inputs, to_peak=False, seed=7, float64=False, wrt=None):
    """Forward of both and the gradients of ``sum(out * cotangent)`` with
    respect to the inputs ``wrt`` (every input by default); ``float64``
    runs both packages in float64."""
    if float64:
        with jax.enable_x64(True):
            return vjp_close(jfn, tfn, [np.float64(x) for x in inputs], to_peak, seed,
                             wrt=wrt)
    jouts, vjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(x) for x in inputs])
    xs = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    out = tfn(*xs)
    close(out, jouts, to_peak)
    cot = np.asarray(rand(*out.shape, seed=seed), dtype=np.asarray(jouts).dtype)
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(out, xs, torch.from_numpy(cot), allow_unused=True,
                                 materialize_grads=True)
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        if wrt is None or i in wrt:
            leaf_close(a.numpy(), b, f"input {i}")
    return out


def with_zeros(x, every=3):
    """``x`` with every ``every``-th entry exactly 0 (and -0.0 beside)."""
    x = np.array(x)
    flat = x.reshape(-1)
    flat[::every] = 0.0
    flat[1::every * 2] = -0.0
    return x


# ---- banks


@pytest.mark.parametrize("spacing", ["linear", "geometric", (100.0, 440.0, 2000.0)])
def test_gammatone_bank_is_bit_identical(spacing):
    n = 3 if isinstance(spacing, tuple) else 8
    want = np.asarray(jgt.gammatone_filter_bank(n, 64, samplerate=22050, band_spacing=spacing))
    got = gammatone.gammatone_filter_bank(n, 64, samplerate=22050, band_spacing=spacing)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        gammatone.gammatone_filter_bank(4, 16, band_spacing="mel")


@pytest.mark.parametrize("scaling", [0.1, "geomspace"])
def test_morlet_banks_are_bit_identical(scaling):
    freqs = jfb.mel_scale_hz(20, 11000, 6)
    np.testing.assert_array_equal(filterbank.mel_scale_hz(20, 11000, 6), freqs)
    np.testing.assert_array_equal(filterbank.morlet(65, 3.0, 0.5), jfb.morlet(65, 3.0, 0.5))
    s = np.geomspace(0.25, 0.9, num=6) if scaling == "geomspace" else scaling
    for normalize in (True, False):
        np.testing.assert_array_equal(filterbank.morlet_filter_bank(22050, 64, freqs, s,
                                                                    normalize),
                                      jfb.morlet_filter_bank(22050, 64, freqs, s, normalize))


# ---- filterbank.py


@pytest.mark.parametrize("padding", [None, 16])
def test_filter_bank_convolve(padding):
    bank = jfb.morlet_filter_bank(22050, 64, jfb.mel_scale_hz(20, 11000, 6), 0.1).real
    bank = bank.astype(np.float32)
    vjp_close(lambda x, d: jfb.filter_bank_convolve(x, d, padding),
              lambda x, d: filterbank.filter_bank_convolve(x, d, padding),
              [rand(2, 1024), bank], to_peak=True)


@pytest.mark.parametrize("kernel,stride,padding", [(64, 1, 32), (32, 32, 16), (64, 32, 32),
                                                   (2, 1, 1)])
def test_avg_pool_1d_on_exact_zeros(kernel, stride, padding):
    x = np.maximum(rand(2, 3, 256, seed=1), 0.0)   # a rectified signal: half exact zeros
    vjp_close(lambda v: jfb.avg_pool_1d(v, kernel, stride, padding),
              lambda v: filterbank.avg_pool_1d(v, kernel, stride, padding), [x])
    # a transposed (non-contiguous) input pools as its contiguous copy
    xt = t(x).transpose(0, 1)
    np.testing.assert_array_equal(filterbank.avg_pool_1d(xt, kernel, stride, padding).numpy(),
                                  filterbank.avg_pool_1d(xt.contiguous(), kernel, stride,
                                                         padding).numpy())


# ---- aim.py


def test_rectified_filter_bank_and_aim():
    bank = np.asarray(jgt.gammatone_filter_bank(4, 64))
    sig = rand(1, 1, 1024, seed=2)
    # every gammatone filter's first tap is exactly 0, so the first output,
    # x[0] * 0, sits on the rectifier's kink, and FFT rounding (+-1e-16 in
    # float64) picks its side: the bank's gradient at that tap then differs
    # between the packages by x[0] * cotangent (3.8e-3 of its largest here),
    # in float64 too. The gradient into the signal passes through that tap
    # times 0 and agrees; no user of the bank learns it, so the gradients
    # are held with respect to the signal.
    vjp_close(jaim.rectified_filter_bank, aim.rectified_filter_bank, [sig, bank], to_peak=True,
              wrt=[0])
    # log(x + 1e-8): that first output is log(1e-8) or log(1.2e-7) after
    # float32 rounding, so the log form is held in float64
    vjp_close(lambda x, d: jaim.rectified_filter_bank(x, d, True),
              lambda x, d: aim.rectified_filter_bank(x, d, True), [sig, bank], to_peak=True,
              float64=True, wrt=[0])
    out = vjp_close(lambda x, d: jaim.auditory_image_model(x, d, 128, 64),
                    lambda x, d: aim.auditory_image_model(x, d, 128, 64), [sig, bank],
                    to_peak=True, wrt=[0])
    assert out.shape[:2] == (1, 4) and out.shape[-1] == 65


@pytest.mark.parametrize("windowing,causal,norm", [(True, False, False), (False, True, False),
                                                   (True, False, True)])
def test_auditory_image(windowing, causal, norm):
    x = np.maximum(rand(2, 3, 1024, seed=3), 0.0)
    vjp_close(lambda v: jaim.auditory_image(v, 128, 16, windowing, True, causal, norm),
              lambda v: aim.auditory_image(v, 128, 16, windowing, True, causal, norm), [x],
              to_peak=True)
    with pytest.raises(ValueError, match="COLA"):
        aim.auditory_image(t(x), 128, 32)


# ---- feature.py


def test_cochlea_model_and_periodicity_feature():
    bank = feature.cochlea_filter_bank(8, 64)
    np.testing.assert_array_equal(bank, np.asarray(jfeat.cochlea_filter_bank(8, 64)))
    sig = rand(2, 1, 1024, seed=4)
    out = vjp_close(lambda x: jfeat.cochlea_model(x, jnp.asarray(bank)),
                    lambda x: feature.cochlea_model(x, t(bank)), [sig], to_peak=True)
    assert out.shape == (2, 8, 1024) and float(out.min()) >= 0
    m, jm = feature.CochleaModel(n_filters=16, kernel_size=128, device="cpu"), \
        jfeat.CochleaModel(n_filters=16, kernel_size=128)
    np.testing.assert_array_equal(m.filters.numpy(), np.asarray(jm.filters))
    close(m(t(sig)), jax.jit(jm.__call__)(jnp.asarray(sig)), to_peak=True)
    x = rand(2, 3, 512, seed=5)
    jp = jax.jit(lambda v: jfeat.periodicity_feature(v, 64, 32))(jnp.asarray(x))
    tp = feature.periodicity_feature(t(x), 64, 32)
    assert tp.is_complex() and tuple(tp.shape) == jp.shape
    close(tp.real, jnp.real(jp), to_peak=True)
    close(tp.imag, jnp.imag(jp), to_peak=True)


# ---- scattering.py


def test_scattering_transform():
    bank = jfb.morlet_filter_bank(22050, 64, jfb.mel_scale_hz(20, 11000, 6), 0.1).real
    bank = bank.astype(np.float32)
    sig = with_zeros(rand(1, 1024, seed=6))
    jc1, jc2 = jax.jit(lambda x: jsc.scattering_transform(x, jnp.asarray(bank), 64, 32))(
        jnp.asarray(sig))
    c1, c2 = scattering.scattering_transform(t(sig), t(bank), 64, 32)
    close(c1, jc1, to_peak=True)
    close(c2, jc2, to_peak=True)
    vjp_close(lambda x: jnp.concatenate([c.reshape(-1) for c in jsc.scattering_transform(
                  x, jnp.asarray(bank), 64, 32)]),
              lambda x: torch.cat([c.reshape(-1) for c in scattering.scattering_transform(
                  x, t(bank), 64, 32)]), [sig], to_peak=True)


def test_more_correct_scattering():
    freqs = jfb.mel_scale_hz(20, 11000, 6)
    jm = jsc.MoreCorrectScattering(22050, freqs, 64)
    m = scattering.MoreCorrectScattering(22050, freqs, 64, device="cpu")
    np.testing.assert_array_equal(m.filter_bank.numpy(), np.asarray(jm.filter_bank))
    out = vjp_close(jm.__call__, m, [rand(1, 1, 1024, seed=7)], to_peak=True)
    assert out.shape == (1, 6 + sum(range(2, 6)), 32)


# ---- psychoacoustic.py


def test_psychoacoustic_feature_and_loss():
    jp, tp = jpa.PsychoacousticFeature(n_bands=8), psychoacoustic.PsychoacousticFeature(
        n_bands=8, device="cpu")
    for k in jp.banks:
        np.testing.assert_array_equal(tp.banks[k].numpy(), np.asarray(jp.banks[k]))
    assert tp.band_sizes == jp.band_sizes
    a, b = rand(1, 1, 16384, seed=8), rand(1, 1, 16384, seed=9)
    vjp_close(jp.__call__, tp, [a], to_peak=True)
    vjp_close(jp.loss, tp.loss, [a, b])
    assert float(tp.loss(t(a), t(a))) < 1e-9
    jd = jax.jit(lambda x: jp.compute_feature_dict(x, constant_window_size=64, time_steps=8))(
        jnp.asarray(a))
    td = tp.compute_feature_dict(t(a), constant_window_size=64, time_steps=8)
    for k in jd:
        close(td[k], jd[k], to_peak=True)


# ---- texture.py


def test_calculate_kurtosis():
    """The moments' sums are rounded in another order in each package and
    the ratio, about 2, loses digits to the subtraction of 3: the values
    are held at atol 1e-5 (measured 1.4e-6 at rtol 3.4e-5)."""
    x = rand(2, 20, 50, seed=10)
    for axis in (-1, 1):
        jk = jax.jit(lambda v: jtex.calculate_kurtosis(v, axis))(jnp.asarray(x))
        np.testing.assert_allclose(texture.calculate_kurtosis(t(x), axis).numpy(),
                                   np.asarray(jk), rtol=1e-5, atol=1e-5)
        vjp_close(lambda v: jtex.calculate_kurtosis(v, axis) + 3.0,
                  lambda v: texture.calculate_kurtosis(v, axis) + 3.0, [x])


def test_audio_texture_features_and_loss():
    jf = jtex.AudioTextureFeatures(2048, n_filters=8, filter_size=32, min_band_size=512)
    tf = texture.AudioTextureFeatures(2048, n_filters=8, filter_size=32, min_band_size=512,
                                      device="cpu")
    np.testing.assert_allclose(tf.fb.numpy(), np.asarray(jf.fb), rtol=1e-6, atol=1e-7)
    a, b = rand(2, 1, 2048, seed=11, scale=0.3), rand(2, 1, 2048, seed=12, scale=0.3)
    vjp_close(jf.__call__, tf, [a], to_peak=True)
    vjp_close(jf.loss, tf.loss, [a, b])
    # recon == target: every |difference| exactly at 0, where jnp.abs passes
    # the whole gradient (kinks.abs)
    vjp_close(jf.loss, tf.loss, [a, a])


# ---- config/experiment.py


@pytest.fixture(scope="module")
def experiments():
    kw = dict(model_dim=16, kernel_size=128)
    return JExperiment(22050, 4096, **kw), Experiment(22050, 4096, **kw, device="cpu")


def test_experiment_bank_and_features(experiments):
    je, te = experiments
    np.testing.assert_array_equal(te.filters.numpy(), np.asarray(je.filters))
    sig = rand(2, 1, 4096, seed=13)
    out = vjp_close(je.perceptual_feature, te.perceptual_feature, [sig], to_peak=True)
    assert out.shape == (2, 16, 16, 257)
    vjp_close(je.apply_filter_bank, te.apply_filter_bank, [sig], to_peak=True)


def test_experiment_pooled_filter_bank_on_ties(experiments):
    """The pooled bank of a signal; then the pooling itself on a rectified
    input whose first 1,024 samples are exact zeros (whole windows of
    ties): both packages send a window's gradient to its first largest
    entry. (A silent stretch of the signal itself does not make such ties:
    the FFT convolution leaves rounding noise there, which then picks the
    maxima, differently in each package.)"""
    je, te = experiments
    out = vjp_close(je.pooled_filter_bank, te.pooled_filter_bank,
                    [rand(1, 1, 4096, seed=14)], to_peak=True)
    assert out.shape == (1, 16, 16)
    fb = np.maximum(rand(1, 2, 4096, seed=15), 0.0)
    fb[..., :1024] = 0.0
    vjp_close(lambda v: jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, 1, 512),
                                              (1, 1, 256), ((0, 0), (0, 0), (256, 256))),
              lambda v: torch.nn.functional.max_pool1d(v, 512, 256, padding=256), [fb])


def test_experiment_triune_and_losses(experiments):
    je, te = experiments
    a, b = rand(1, 1, 4096, seed=16), rand(1, 1, 4096, seed=17)
    vjp_close(lambda x: jnp.concatenate([v.reshape(-1) for v in je.perceptual_triune(x)]),
              lambda x: torch.cat([v.reshape(-1) for v in te.perceptual_triune(x)]), [a],
              to_peak=True)
    place, pop, spikes = te.perceptual_triune(t(a))
    assert place.shape == (1, 16, 16) and pop.shape == (1, 2, 16) and spikes.shape[-1] == 257
    for norm in ("l2", "l1"):
        vjp_close(lambda x, y: je.perceptual_loss(x, y, norm),
                  lambda x, y: te.perceptual_loss(x, y, norm), [a, b])
    vjp_close(lambda x, y: je.perceptual_loss(x, y, "l1"),   # every |difference| at 0
              lambda x, y: te.perceptual_loss(x, y, "l1"), [a, a])


def test_config_is_a_package_with_the_old_names():
    from mptpu_torch import config
    from mptpu_torch.config import audio_path, cache_path, impulse_response_path, parse_dotenv

    assert config.dotenv.audio_path is audio_path and callable(cache_path)
    assert callable(impulse_response_path) and parse_dotenv("no such file") == {}
