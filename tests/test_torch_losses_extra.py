"""The remaining losses (ROADMAP A5) in the port against ``mptpu`` on
JAX-CPU: ``losses/{autocorrelation,correlation,serial,gan,infoloss}.py``,
at the sizes of ``tests/test_losses.py`` and
``tests/test_inventory_extras.py``. ``mptpu``'s random draws (the noise
losses' normal draws and permutation) are carried across; the info losses
carry ``mptpu``'s flax trees by ``convert.module_from_flax``. Each loss's
gradient is taken with respect to the reconstruction (``jax.grad`` against
``torch.autograd.grad``), the info losses' also with respect to their
parameters.

Tolerances: forwards rtol 1e-5 / atol 1e-6 (outputs made by FFTs at atol
1e-6 of their peak); gradients within 1e-4 of each tensor's largest;
codes, counts and shapes exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.losses import autocorrelation as jac
from mptpu.losses import correlation as jcor
from mptpu.losses import gan as jgan
from mptpu.losses import infoloss as jinfo
from mptpu.losses import serial as jser
from mptpu.ops.stft import stft as j_stft
from mptpu_torch import convert
from mptpu_torch.losses import autocorrelation, correlation, gan, infoloss, serial
from mptpu_torch.ops.stft import stft

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


def close(port, want, to_peak=False, peak_share=1e-6):
    want = np.asarray(want)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == want.shape
    atol = peak_share * np.abs(want).max() if to_peak else FWD["atol"]
    np.testing.assert_allclose(port, want, rtol=FWD["rtol"], atol=atol)


def leaf_close(port, want, where=""):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


def loss_and_grad_close(jloss, tloss, target, recon):
    """The loss of (target, recon) and its gradient by the recon (in the
    inputs' dtype)."""
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=1))(jnp.asarray(target),
                                                           jnp.asarray(recon))
    r = torch.from_numpy(np.array(recon)).requires_grad_()
    loss = tloss(torch.from_numpy(np.array(target)), r)
    (g,) = torch.autograd.grad(loss, r)
    np.testing.assert_allclose(float(loss), float(jl), **FWD)
    leaf_close(g.numpy(), jg, "the gradient by the recon")
    return float(loss)


def j_transform(x):
    return j_stft(x, 128, 64, pad=True)


def transform(x):
    return stft(x, 128, 64, pad=True)


# ---- autocorrelation.py


def test_autocorrelation_frame_pads_by_the_step():
    x = rand(2, 3, 100)
    for window, step in ((16, 8), (32, 8), (128, 64)):
        np.testing.assert_array_equal(autocorrelation._frame(t(x), window, step).numpy(),
                                      np.asarray(jac._frame(jnp.asarray(x), window, step)))


def test_autocorrelation_loss():
    jl = jac.AutocorrelationLoss(n_channels=8, filter_size=64)
    tl = autocorrelation.AutocorrelationLoss(n_channels=8, filter_size=64, device="cpu")
    np.testing.assert_allclose(tl.gammatone.numpy(), np.asarray(jl.gammatone), rtol=1e-6,
                               atol=1e-7)
    target, recon = rand(2, 1, 1024, seed=1), rand(2, 1, 1024, seed=2, scale=0.5)
    close(tl.features(t(target), 64, 32),
          jax.jit(lambda x: jl.features(x, 64, 32))(jnp.asarray(target)), to_peak=True)
    loss_and_grad_close(jl.loss, tl.loss, target, recon)
    loss_and_grad_close(jl.multiband_loss, tl.multiband_loss, target, recon)
    assert float(tl(t(target), t(target))) == 0.0


def test_decay_loss():
    jl = jac.DecayLoss(2048, n_decays=8, window_size=256)
    tl = autocorrelation.DecayLoss(2048, n_decays=8, window_size=256, device="cpu")
    np.testing.assert_array_equal(tl.decays.numpy(), np.asarray(jl.decays))
    target, recon = rand(2, 1, 2048, seed=3), rand(2, 1, 2048, seed=4, scale=0.5)
    close(tl.features(t(target)), jax.jit(jl.features)(jnp.asarray(target)), to_peak=True)
    loss_and_grad_close(jl.loss, tl.loss, target, recon)


L1_AT_ZERO = {
    "AutocorrelationLoss.loss": lambda pkg: pkg.AutocorrelationLoss(n_channels=8, filter_size=64,
                                                                    **DEV[pkg]).loss,
    "AutocorrelationLoss.multiband_loss": lambda pkg: pkg.AutocorrelationLoss(
        n_channels=8, filter_size=64, **DEV[pkg]).multiband_loss,
    "DecayLoss": lambda pkg: pkg.DecayLoss(2048, n_decays=8, window_size=256, **DEV[pkg]).loss,
}
DEV = {jac: {}, autocorrelation: {"device": "cpu"}}


@pytest.mark.parametrize("name", sorted(L1_AT_ZERO))
def test_l1_losses_at_recon_equal_to_target(name):
    """recon == target puts every |t - r| exactly at 0, where ``jnp.abs``
    passes the whole gradient (``kinks.abs``; ``torch.abs`` would pass
    none): the loss 0 and the gradient by the recon ``mptpu``'s."""
    x = rand(2, 1, 2048, seed=30)
    loss = loss_and_grad_close(L1_AT_ZERO[name](jac), L1_AT_ZERO[name](autocorrelation), x, x)
    assert loss == 0.0


# ---- correlation.py


def test_covariance():
    x = rand(10, 4, seed=5)
    close(correlation.covariance(t(x)), jcor.covariance(jnp.asarray(x)))


def test_noise_losses_with_mptpus_draws():
    key = jax.random.PRNGKey(3)
    target, recon = rand(1, 1, 4096, seed=6), rand(1, 1, 4096, seed=7, scale=2.0)
    shape = (1, 1024 * 16)   # stft_transform(2048, 256) of 4,096 samples, flattened
    noise = t(jax.random.normal(key, shape))
    loss_and_grad_close(lambda a, b: jcor.noise_loss(key, a, b),
                        lambda a, b: correlation.noise_loss(a, b, noise=noise), target, recon)
    noises = []
    for i, size in enumerate((512, 1024, 2048, 4096)):
        noises.append(t(jax.random.normal(jax.random.fold_in(key, i), (1, 128 * (size // 64)))))
    loss_and_grad_close(lambda a, b: jcor.multiband_noise_loss(key, a, b, 256, 64),
                        lambda a, b: correlation.multiband_noise_loss(a, b, 256, 64,
                                                                      noises=noises),
                        target, recon)
    gen = torch.Generator().manual_seed(0)
    assert np.isfinite(float(correlation.noise_loss(t(target), t(recon), generator=gen)))


def test_correlation_loss_with_mptpus_draws():
    key = jax.random.PRNGKey(0)
    target, recon = rand(1, 1, 4096, seed=8), rand(1, 1, 4096, seed=9, scale=3.0)
    k_noise, k_perm = jax.random.split(key)
    noise = t(jax.random.normal(k_noise, (1, 1024 * 16)))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, 1024 * 16)))
    loss_and_grad_close(lambda a, b: jcor.correlation_loss(key, a, b, n_elements=64),
                        lambda a, b: correlation.correlation_loss(a, b, 64, noise, perm),
                        target, recon)
    m = correlation.CorrelationLoss(n_elements=64)
    np.testing.assert_allclose(float(m(t(target), t(recon), noise=noise, indices=perm)),
                               float(jcor.CorrelationLoss(64)(key, jnp.asarray(target),
                                                              jnp.asarray(recon))), **FWD)
    gen = torch.Generator().manual_seed(0)
    same = float(m(t(target), t(target), generator=gen))
    assert same < float(m(t(target), t(recon), generator=torch.Generator().manual_seed(0)))


# ---- serial.py


def test_serial_matching_pursuit():
    """The FFT shift's phase ramp reaches 2 pi x 85 rad at a lag of 85 of
    256 samples, where float32 keeps 3e-5 rad, and the two packages round
    the ramp's products otherwise: the residual and recon are held at 1e-5
    of their peak in float32 (measured 5.1e-6; the lags are identical) and
    at 1e-10 in float64."""
    inp, target = rand(2, 3, 256, seed=10), rand(2, 1, 256, seed=11)
    jres, jrec = jax.jit(jser.serial_matching_pursuit)(jnp.asarray(inp), jnp.asarray(target))
    res, rec = serial.serial_matching_pursuit(t(inp), t(target))
    close(res, jres, to_peak=True, peak_share=1e-5)
    close(rec, jrec, to_peak=True, peak_share=1e-5)
    with jax.enable_x64(True):
        jres, jrec = jax.jit(jser.serial_matching_pursuit)(jnp.asarray(np.float64(inp)),
                                                           jnp.asarray(np.float64(target)))
    res, rec = serial.serial_matching_pursuit(torch.from_numpy(np.float64(inp)),
                                              torch.from_numpy(np.float64(target)))
    close(res, jres, to_peak=True, peak_share=1e-10)
    close(rec, jrec, to_peak=True, peak_share=1e-10)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jser.serial_matching_pursuit(
        a, jnp.asarray(target))[1] ** 2)))(jnp.asarray(inp))
    x = t(inp).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(serial.serial_matching_pursuit(x, t(target))[1] ** 2),
                               x)
    leaf_close(g.numpy(), jg, "the gradient by the events")


def test_serial_loss():
    target = rand(1, 1, 512, seed=12)
    events = rand(1, 3, 512, seed=13, scale=0.3)
    loss_and_grad_close(lambda a, b: jser.serial_loss(b, a, j_transform),
                        lambda a, b: serial.serial_loss(b, a, transform), target, events)
    zeros = np.zeros((1, 3, 512), np.float32)   # every event silent: |x| at exactly 0
    loss_and_grad_close(lambda a, b: jser.serial_loss(b, a, j_transform),
                        lambda a, b: serial.serial_loss(b, a, transform), target, zeros)


# ---- gan.py


def test_gan_losses():
    r, f = rand(4, 3, seed=14), rand(4, 3, seed=15)
    assert float(gan.least_squares_generator_loss(torch.tensor([0.5, 0.5]))) == 0.125
    assert float(gan.least_squares_disc_loss(torch.ones(2), torch.zeros(2))) == 0.0
    loss_and_grad_close(lambda a, b: jgan.least_squares_disc_loss(a, b),
                        lambda a, b: gan.least_squares_disc_loss(a, b), r, f)
    loss_and_grad_close(lambda a, b: jgan.least_squares_generator_loss(b) + jgan.squared_gan_loss(
        b, a), lambda a, b: gan.least_squares_generator_loss(b) + gan.squared_gan_loss(b, a),
        r, f)


# ---- infoloss.py


def test_patches2():
    spec = rand(2, 32, 16, seed=16)
    jp, jn, jnormed = jax.jit(lambda s: jinfo.patches2(s, (8, 8), (4, 4)))(jnp.asarray(spec))
    p, n, normed = infoloss.patches2(t(spec), (8, 8), (4, 4))
    assert tuple(p.shape) == jp.shape == (2, 21, 40)
    for a, b in ((p, jp), (n, jn), (normed, jnormed)):
        close(a, b, to_peak=True)
    jg = jax.jit(jax.grad(lambda s: jnp.sum(jinfo.patches2(s, (8, 4), (4, 2))[2] ** 3)))(
        jnp.asarray(spec))
    x = t(spec).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(infoloss.patches2(x, (8, 4), (4, 2))[2] ** 3), x)
    leaf_close(g.numpy(), jg, "patches2")


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def decisive(params):
    """``mptpu``'s init with every kernel 50 times wider (uniform +-1). At
    the init the scores are about 1e-4 and their two largest stand as
    little as 1.5e-8 apart, against 1e-10 of float32 rounding between the
    packages: a near tie may then pick another code in each, which moves
    the loss (these losses are functions of the codes). Wider kernels
    decide every code beyond rounding, so that codes can be held exactly."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * 50.0 if jax.tree_util.keystr(path).endswith("['kernel']") else v,
        params)


def info_case(jm, tm, target, recon, float64=False):
    """``mptpu``'s parameters (:func:`decisive`) carried into the port;
    the loss, its gradient by the recon and by the parameters (in float64
    on both sides when ``float64``); the round trip back to a flax tree."""
    params = decisive(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(target),
                                       jnp.asarray(recon)))
    convert.module_from_flax(tm, params)
    back = flat(convert.module_to_flax(tm)["params"])
    for k, v in flat(params["params"]).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if float64:
        tm.double()
        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), params)
            return grads_case(jm, tm, params, np.float64(target), np.float64(recon))
    return grads_case(jm, tm, params, target, recon)


def grads_case(jm, tm, params, target, recon):
    a, b = jnp.asarray(target), jnp.asarray(recon)
    loss_and_grad_close(lambda x, y: jm.apply(params, x, y), tm, target, recon)
    jg = flat(jax.jit(jax.grad(lambda p: jm.apply(p, a, b)))(params)["params"])
    ps = list(tm.parameters())
    grads = torch.autograd.grad(tm(torch.from_numpy(target), torch.from_numpy(recon)), ps)
    saved = [p.detach().clone() for p in ps]
    with torch.no_grad():
        for p, g in zip(ps, grads):
            p.copy_(g)
        tg = flat(convert.module_to_flax(tm)["params"])
        for p, s in zip(ps, saved):
            p.copy_(s)
    for k in jg:
        leaf_close(tg[k], jg[k], k)
    return params


def test_spectral_info_loss_codes_and_gradients():
    kw = dict(stft_window_size=256, stft_step_size=64, patch_size=(8, 8), patch_step=(4, 4),
              n_centroids=32)
    jm, tm = jinfo.SpectralInfoLoss(**kw), infoloss.SpectralInfoLoss(**kw, device="cpu")
    target, recon = rand(1, 1, 2048, seed=17), rand(1, 1, 2048, seed=18)
    params = info_case(jm, tm, target, recon)
    names = ("one_hot", "codes", "weights", "norms", "normed", "raw")
    layers = params["params"]

    def j_encode(x):
        def dense(name, h):
            return h @ layers[name]["kernel"] + layers[name]["bias"]
        frames = x.shape[-1] // 64
        spec = j_stft(x, 256, 64, pad=True).reshape(-1, frames, 129)
        raw, norms, normed = jinfo.patches2(spec, (8, 8), (4, 4))
        h = dense("up", dense("proj", dense("patch_embed", normed)))
        codes = jnp.argmax(h, axis=-1)
        counts = jnp.bincount(codes.reshape(-1), length=32) + 1
        return codes, counts

    jcodes, jcounts = jax.jit(j_encode)(jnp.asarray(target))
    got = dict(zip(names, tm.encode(t(target))))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal((1.0 / got["weights"] * got["codes"].numel()).round().numpy(),
                                  np.asarray(jcounts))
    assert float(tm(t(target), t(target))) <= float(tm(t(target), t(recon))) + 1e-3


def test_multi_window_spectral_info_loss():
    specs = (((16, 16), (8, 8)), ((8, 16), (4, 8)))
    jm = jinfo.MultiWindowSpectralInfoLoss(specs=specs)
    tm = infoloss.MultiWindowSpectralInfoLoss(specs=specs, device="cpu")
    assert {n for n, _ in tm.named_children()} == {"model_0", "model_1"}
    info_case(jm, tm, rand(1, 1, 8192, seed=19), rand(1, 1, 8192, seed=20))


def test_multi_band_spectral_info_loss():
    """Bands of 1,024 and 2,048 samples at a hop of 64: 16 and 32 frames,
    enough for a 16 x 16 patch. At the defaults the 512-sample band has 8
    frames, no patch, and the loss is NaN in both packages.

    A band holds only its upper octave, so the patches below it hold the
    STFT window's leakage, under float32 rounding: their unit-normed
    magnitudes are rounding noise divided by norms near 1e-7, and the
    gradient through them differed by 0.8 of its largest between the
    packages in float32 (the loss by 6e-7). Both run in float64 here."""
    jm = jinfo.MultiBandSpectralInfoLoss(band_sizes=(1024, 2048))
    tm = infoloss.MultiBandSpectralInfoLoss(band_sizes=(1024, 2048), device="cpu")
    info_case(jm, tm, rand(1, 1, 2048, seed=21), rand(1, 1, 2048, seed=22), float64=True)
    a, b = rand(1, 1, 2048, seed=23), rand(1, 1, 2048, seed=24)
    jd = jinfo.MultiBandSpectralInfoLoss()
    params = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    assert np.isnan(float(jax.jit(jd.apply)(params, jnp.asarray(a), jnp.asarray(b))))
    td = convert.module_from_flax(infoloss.MultiBandSpectralInfoLoss(device="cpu"), params)
    assert np.isnan(float(td(t(a), t(b))))
