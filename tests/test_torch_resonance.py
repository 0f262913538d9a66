"""The resonance chain and impulse generator (ROADMAP A6) and
``gen/ddsp.py`` in the port against ``mptpu`` on JAX-CPU:
``gen/{ddsp,impulse,transfer}.py`` and ``models/resonance_overfit.py``,
whose stack is built at the script's full width and steps at ``--tiny``
against the script's jitted step (restated here from its lines, which live
inside its ``main``). ``mptpu``'s flax trees are carried by
``convert.module_from_flax``; its noise draws (``uniform(key, shape, -1,
1)`` from the key it was handed) are passed to the port as tensors. The
other two entry points of the slice are in
``tests/test_torch_perceptual_scripts.py``.

Tolerances: forwards rtol 1e-5 / atol 1e-6 (outputs made by FFTs at atol
1e-6 of their peak); gradients within 1e-4 of each leaf's largest; one
Adam step's loss rtol 1e-5 and its parameters within 1e-3 of the learning
rate of optax's. Wider, each measured: the oscillator and harmonic banks
sum phases by a running sum to thousands of radians, where float32 keeps
about 1e-3 rad, so they are held in float64 on both sides
(``jax.enable_x64``).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.gen import ddsp as jddsp
from mptpu.gen import impulse as jimp
from mptpu.gen import transfer as jtr
from mptpu.losses.autocorrelation import AutocorrelationLoss as JAC
from mptpu.losses.autocorrelation import DecayLoss as JDL
from mptpu.losses.multiband_spec import flattened_multiband_spectrogram as j_fmbs
from mptpu_torch import convert
from mptpu_torch.gen import ddsp, impulse, transfer
from mptpu_torch.models import resonance_overfit as tro
from mptpu_torch.train.optim import Adam

REPO = Path(__file__).resolve().parent.parent
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4
KEY = jax.random.PRNGKey(0)


def load_script(name):
    """``scripts/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


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


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def trees_close(port, want):
    port, want = flat(port), flat(want)
    assert set(port) == set(want)
    for k in want:
        leaf_close(port[k], want[k], k)


def port_grads(module, loss):
    """The gradients of ``loss`` laid out as the module's flax tree."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(g)
        tree = convert.module_to_flax(module)["params"]
        for p, s in zip(params, saved):
            p.copy_(s)
    return tree


def round_trip(module, params):
    """``module_from_flax`` then ``module_to_flax`` gives the tree back."""
    back = flat(convert.module_to_flax(convert.module_from_flax(module, params))["params"])
    want = flat(params["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    return module


def draws(key, shape):
    """``mptpu``'s noise from ``key``: uniform in [-1, 1)."""
    return np.asarray(jax.random.uniform(key, shape, minval=-1.0, maxval=1.0))


def module_case(jm, tm, args, key, noise_shape, cot_seed=9):
    """``mptpu``'s init carried into ``tm``, the forward from ``key``'s
    draws, and the gradients of ``sum(out * cotangent)`` by the parameters
    and the first input."""
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(jm.init)(KEY, *jargs, key)
    round_trip(tm, params)
    noise = t(draws(key, noise_shape))
    x = t(args[0]).requires_grad_()
    out = tm(x, *[t(a) for a in args[1:]], noise)
    want = jax.jit(jm.apply)(params, *jargs, key)
    close(out, want, to_peak=True)
    cot = rand(*out.shape, seed=cot_seed)
    jg_p, jg_x = jax.jit(jax.grad(lambda p, a: jnp.sum(jm.apply(p, a, *jargs[1:], key) * cot),
                                  argnums=(0, 1)))(params, jargs[0])
    trees_close(port_grads(tm, torch.sum(tm(x, *[t(a) for a in args[1:]], noise) * t(cot))),
                jg_p["params"])
    (gx,) = torch.autograd.grad(torch.sum(tm(x, *[t(a) for a in args[1:]], noise) * t(cot)), x)
    leaf_close(gx.numpy(), jg_x, "input")
    return params


# ---- gen/ddsp.py


def test_noise_spec_and_band_filtered_noise():
    key = jax.random.PRNGKey(3)
    x = t(draws(key, (2048,)))
    want = jax.jit(lambda k: jddsp.noise_spec(k, 2048, 256, 128))(key)
    got = ddsp.noise_spec(2048, 256, 128, noise=x)
    close(got.real, jnp.real(want), to_peak=True)
    close(got.imag, jnp.imag(want), to_peak=True)
    mean = np.random.default_rng(1).uniform(0.1, 0.9, (2, 3, 16)).astype(np.float32)
    std = np.random.default_rng(2).uniform(0.01, 0.2, (2, 3, 16)).astype(np.float32)
    cot = rand(2, 3, 2048, seed=3)

    def jf(m, s):
        return jddsp.band_filtered_noise(key, 2048, 256, 128, m, s)

    out = ddsp.band_filtered_noise(2048, 256, 128, t(mean).requires_grad_(),
                                   t(std).requires_grad_(), noise=x)
    close(out, jax.jit(jf)(jnp.asarray(mean), jnp.asarray(std)), to_peak=True)
    jg = jax.jit(jax.grad(lambda m, s: jnp.sum(jf(m, s) * cot), argnums=(0, 1)))(
        jnp.asarray(mean), jnp.asarray(std))
    m, s = t(mean).requires_grad_(), t(std).requires_grad_()
    tg = torch.autograd.grad(torch.sum(ddsp.band_filtered_noise(2048, 256, 128, m, s, noise=x)
                                       * t(cot)), (m, s))
    for a, b, w in zip(tg, jg, ("mean", "std")):
        leaf_close(a.numpy(), b, w)


def test_noise_bank2_with_mptpus_draws():
    key = jax.random.PRNGKey(4)
    filt = np.abs(rand(2, 33, 16, seed=4))   # (batch, coeffs, frames): 16 x 32 samples
    noise = t(draws(key, (2, 512)))
    cot = rand(2, 1, 512, seed=5)
    out = ddsp.noise_bank2(t(filt), noise)
    assert tuple(out.shape) == (2, 1, 512)
    close(out, jax.jit(jddsp.noise_bank2)(key, jnp.asarray(filt)), to_peak=True)
    jg = jax.jit(jax.grad(lambda f: jnp.sum(jddsp.noise_bank2(key, f) * cot)))(jnp.asarray(filt))
    f = t(filt).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(ddsp.noise_bank2(f, noise) * t(cot)), f)
    leaf_close(g.numpy(), jg, "filters")
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(ddsp.noise_bank2(t(filt), generator=gen)).all()


def test_oscillator_bank_in_float64():
    with jax.enable_x64(True):
        f0 = np.random.default_rng(6).uniform(0.01, 0.2, (2, 16))
        amps = np.random.default_rng(7).uniform(0, 1, (2, 8, 16))
        cot = np.random.default_rng(8).standard_normal((2, 1, 1024))

        def jf(a, b):
            return jddsp.oscillator_bank(a, b, 1024, 22050, 8)

        want = jax.jit(jf)(jnp.asarray(f0), jnp.asarray(amps))
        jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jf(a, b) * cot), argnums=(0, 1)))(
            jnp.asarray(f0), jnp.asarray(amps))
    a = torch.from_numpy(f0).requires_grad_()
    b = torch.from_numpy(amps).requires_grad_()
    out = ddsp.oscillator_bank(a, b, 1024, 22050, 8)
    close(out, want, to_peak=True)
    for g, w, name in zip(torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), (a, b)),
                          jg, ("f0", "amplitudes")):
        leaf_close(g.numpy(), w, name)


def test_harmonic_model_in_float64():
    hm = ddsp.HarmonicModel(n_voices=4, n_profiles=8, n_harmonics=16, n_frames=16,
                            n_samples=1024)
    jhm = jddsp.HarmonicModel(n_voices=4, n_profiles=8, n_harmonics=16, n_frames=16,
                              n_samples=1024)
    profiles = hm.init_profiles(torch.Generator().manual_seed(0), device="cpu")
    assert profiles.shape == (8, 16) and 0 <= float(profiles.min()) and float(profiles.max()) < 0.1
    rng = np.random.default_rng(9)
    prof = rng.uniform(0, 0.1, (8, 16))
    f0 = rng.standard_normal((1, 4 * 2 * 16))
    harm = rng.standard_normal((1, 4 * 8 * 16))
    cot = rng.standard_normal((1, 1, 1024))
    with jax.enable_x64(True):
        want = jax.jit(jhm.__call__)(jnp.asarray(prof), jnp.asarray(f0), jnp.asarray(harm))
        jg = jax.jit(jax.grad(lambda *a: jnp.sum(jhm(*a) * cot), argnums=(0, 1, 2)))(
            jnp.asarray(prof), jnp.asarray(f0), jnp.asarray(harm))
    xs = [torch.from_numpy(v).requires_grad_() for v in (prof, f0, harm)]
    out = hm(*xs)
    close(out, want, to_peak=True)
    for g, w, name in zip(torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), xs), jg,
                          ("profiles", "f0", "harmonics")):
        leaf_close(g.numpy(), w, name)


# ---- gen/impulse.py


@pytest.mark.parametrize("activation,squared,mask_after", [("sigmoid", True, 1),
                                                           ("clamp", False, None)])
def test_noise_model(activation, squared, mask_after):
    kw = dict(input_channels=4, input_size=8, n_noise_frames=32, n_audio_samples=1024,
              channels=8, squared=squared, mask_after=mask_after, activation=activation)
    jm = jimp.NoiseModel(**kw)
    tm = impulse.NoiseModel(**kw, device="cpu")
    x = rand(2, 4, 8, seed=10, scale=3.0)   # enough to clip at +-1 in the clamp form
    module_case(jm, tm, [x], jax.random.PRNGKey(5), (2, 1024))


def test_generate_mix():
    jm = jimp.GenerateMix(latent_dim=6, channels=8, encoding_channels=3, mixer_channels=2)
    tm = impulse.GenerateMix(6, 8, 3, 2, device="cpu")
    x = rand(3, 6, seed=11)
    params = jax.jit(jm.init)(KEY, jnp.asarray(x))
    round_trip(tm, params)
    close(tm(t(x)), jax.jit(jm.apply)(params, jnp.asarray(x)))


def test_generate_impulse():
    jm = jimp.GenerateImpulse(latent_dim=8, channels=16, n_samples=2048, n_filter_bands=16,
                              encoding_channels=1)
    tm = impulse.GenerateImpulse(8, 16, 2048, 16, 1, device="cpu")
    module_case(jm, tm, [rand(1, 8, seed=12, scale=0.5)], jax.random.PRNGKey(6), (1, 2048))


# ---- gen/transfer.py


@pytest.mark.parametrize("kw", [{}, dict(start_phase=True, start_mags=True)])
def test_freq_domain_transfer_function_to_resonance(kw):
    rng = np.random.default_rng(13)
    coeffs = rng.uniform(0.5, 0.99, (2, 33)).astype(np.float32)
    extra = {}
    if kw.pop("start_phase", False):
        extra["start_phase"] = rng.uniform(-np.pi, np.pi, (2, 33)).astype(np.float32)
    if kw.pop("start_mags", False):
        extra["start_mags"] = rng.uniform(0, 1, (2, 33)).astype(np.float32)
    names = list(extra)
    cot = rand(2, 1, 32 * 16, seed=14)

    def jf(c, *e):
        return jtr.freq_domain_transfer_function_to_resonance(64, c, 16, **kw,
                                                              **dict(zip(names, e)))

    def tf(c, *e):
        return transfer.freq_domain_transfer_function_to_resonance(64, c, 16, **kw,
                                                                   **dict(zip(names, e)))

    args = [coeffs] + [extra[n] for n in names]
    out = tf(*[t(a) for a in args])
    # the phase is a running sum of the group delay over the frames, up to
    # 16 pi rad, where float32 keeps 4e-6 rad, and XLA rounds the sum in
    # another order than PyTorch: the resonance holds at 1e-5 of its peak
    # (measured 1.2e-6 of it with a start phase and magnitudes, 5.3e-7 without)
    want = np.asarray(jax.jit(jf)(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) * cot), argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    xs = [t(a).requires_grad_() for a in args]
    for g, w, i in zip(torch.autograd.grad(torch.sum(tf(*xs) * t(cot)), xs), jg, range(9)):
        leaf_close(g.numpy(), w, f"input {i}")


def waves(n_samples=1024, n_f0s=4):
    return np.asarray(jtr.make_waves(n_samples, [110.0 * 2 ** (i / 3) for i in range(n_f0s)],
                                     22050))


@pytest.mark.parametrize("fft_based", [False, True])
def test_resonance_bank(fft_based):
    n = 64 * 128 if fft_based else 1024   # the fft branch renders 128 frames of 64 samples
    initial = waves(n)
    kw = dict(n_resonances=16, window_size=128, n_frames=16)
    jm = jtr.ResonanceBank(**kw, initial=jnp.asarray(initial), fft_based_resonance=fft_based)
    tm = transfer.ResonanceBank(**kw, initial=t(initial), fft_based_resonance=fft_based,
                                device="cpu")
    sels = [np.maximum(rand(2, 3, 16, seed=s), 0.0) for s in (15, 16, 17)]
    params = jax.jit(jm.init)(KEY, *[jnp.asarray(s) for s in sels])
    if fft_based:   # move off the constant init, so that each bin decays otherwise
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.5 * jnp.asarray(rand(*v.shape, seed=18))
            if "fft_res" in jax.tree_util.keystr(p) else v, params)
    round_trip(tm, params)
    out = tm(*[t(s) for s in sels])
    close(out, jax.jit(jm.apply)(params, *[jnp.asarray(s) for s in sels]), to_peak=True)
    cot = rand(*out.shape, seed=19)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, *[jnp.asarray(s) for s in sels]) * cot)))(
        params)
    trees_close(port_grads(tm, torch.sum(tm(*[t(s) for s in sels]) * t(cot))), jg["params"])


def test_time_varying_mix():
    jm = jtr.TimeVaryingMix(latent_dim=6, channels=8, n_mixer_channels=3, n_frames=16)
    tm = transfer.TimeVaryingMix(6, 8, 3, 16, device="cpu")
    x, audio = rand(2, 6, seed=20), rand(2, 3, 1024, seed=21)
    params = jax.jit(jm.init)(KEY, jnp.asarray(x), jnp.asarray(audio))
    round_trip(tm, params)
    out = tm(t(x), t(audio))
    close(out, jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(audio)), to_peak=True)
    cot = rand(*out.shape, seed=22)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x), jnp.asarray(audio))
                                            * cot)))(params)
    trees_close(port_grads(tm, torch.sum(tm(t(x), t(audio)) * t(cot))), jg["params"])


CHAIN = dict(n_atoms=16, window_size=128, n_frames=16, total_samples=1024, mix_channels=3,
             channels=8, latent_dim=6)


def test_resonance_block_shares_one_bank():
    """One ``ResonanceBank_0`` for all mix channels (a bank per channel
    would hold three times the waves and compute something else), and the
    channels' Dense layers ``Dense_1`` to ``Dense_9`` after ``Dense_0``."""
    initial = waves()
    jm = jtr.ResonanceBlock(**CHAIN, initial=jnp.asarray(initial))
    tm = transfer.ResonanceBlock(**CHAIN, initial=t(initial), device="cpu")
    x, imp = rand(1, 6, seed=23), rand(1, 1, 256, seed=24)
    params = jax.jit(jm.init)(KEY, jnp.asarray(x), jnp.asarray(imp))
    assert sorted(params["params"]) == sorted(
        ["ResonanceBank_0", "TimeVaryingMix_0"] + [f"Dense_{i}" for i in range(10)])
    round_trip(tm, params)
    out = tm(t(x), t(imp))
    close(out, jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(imp)), to_peak=True)
    cot = rand(*out.shape, seed=25)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x), jnp.asarray(imp))
                                            * cot)))(params)
    trees_close(port_grads(tm, torch.sum(tm(t(x), t(imp)) * t(cot))), jg["params"])


def test_resonance_chain():
    initial = waves()
    jm = jtr.ResonanceChain(depth=2, **CHAIN, initial=jnp.asarray(initial))
    tm = transfer.ResonanceChain(2, **CHAIN, initial=t(initial), device="cpu")
    assert tm.ResonanceBlock_0.ResonanceBank_0.res_samples is not \
        tm.ResonanceBlock_1.ResonanceBank_0.res_samples
    x, imp = rand(1, 6, seed=26), rand(1, 1, 1024, seed=27)
    params = jax.jit(jm.init)(KEY, jnp.asarray(x), jnp.asarray(imp))
    round_trip(tm, params)
    out = tm(t(x), t(imp))
    close(out, jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(imp)), to_peak=True)
    cot = rand(*out.shape, seed=28)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x), jnp.asarray(imp))
                                            * cot)))(params)
    trees_close(port_grads(tm, torch.sum(tm(t(x), t(imp)) * t(cot))), jg["params"])
    fixed = transfer.ResonanceChain(2, **CHAIN, initial=t(initial), learnable_resonances=False,
                                    device="cpu")
    assert "res_samples" not in dict(fixed.ResonanceBlock_0.ResonanceBank_0.named_parameters())


# ---- models/resonance_overfit.py


@pytest.fixture(scope="module")
def resonance_script():
    return load_script("resonance_overfit")


def test_overfit_resonance_stack_at_the_scripts_full_width(resonance_script):
    """2^15 samples, 128 f0s (512 waves), depth 2, 4 mix channels: built on
    the CPU, not run; every leaf's shape is mptpu's and the count is
    34,090,383."""
    jm = resonance_script.OverfitResonanceStack(n_samples=2**15)
    shapes = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: jm.init(KEY, KEY)))}
    tm = tro.OverfitResonanceStack(2**15, device="cpu")
    got = {k: v.shape for k, v in flat(convert.module_to_flax(tm)).items()}
    assert got == shapes
    assert sum(p.numel() for p in tm.parameters()) == 34_090_383
    assert sum(int(np.prod(s)) for s in shapes.values()) == 34_090_383
    banks = [m for m in tm.modules() if isinstance(m, transfer.ResonanceBank)]
    assert len(banks) == 2 and banks[0].res_samples.shape == (512, 2**15)
    np.testing.assert_array_equal(banks[1].res_samples.detach().numpy(),
                                  np.asarray(jtr.make_waves(2**15, [float(f) for f in
                                      tro.musical_scale_hz(21, 106, 128)], 22050)))


def test_overfit_resonance_stack_round_trip(resonance_script):
    """``mptpu``'s own init at ``--tiny`` carried into the port and back."""
    jm = resonance_script.OverfitResonanceStack(n_samples=2**12)
    params = jax.jit(jm.init)(KEY, KEY)
    tm = round_trip(tro.OverfitResonanceStack(2**12, device="cpu"), params)
    noise = draws(KEY, (1, 4096))
    close(tm(t(noise)), jax.jit(jm.apply)(params, KEY), to_peak=True)


def script_loss(jm, target, n):
    """``scripts/resonance_overfit.py:98-108``."""
    ac = JAC(n_channels=32, filter_size=128)
    dl = JDL(n, n_decays=8, window_size=256)

    def loss_fn(params, key):
        recon = jm.apply(params, key)
        spec = jnp.abs(j_fmbs(recon, stft_spec={"s": (64, 16)}, smallest_band_size=512)
                       - j_fmbs(target, stft_spec={"s": (64, 16)}, smallest_band_size=512)).sum()
        return spec + 0.01 * ac(target, recon) + 0.1 * dl(target, recon), recon

    return loss_fn


def test_resonance_overfit_script_steps_at_tiny(resonance_script):
    """``--tiny`` (2^12 samples) from the port's seed-0 parameters carried
    into ``mptpu``; the target a seeded draw (the script's is
    ``get_one_audio_segment(2**12, seed=9)``, held across packages by
    ``test_torch_data.py``). The port's step and ``overfit_resonance``'s
    two steps against the script's jitted step with ``fold_in(key, i)``."""
    n = 2**12
    target = rand(1, 1, n, seed=29, scale=0.3)
    jm = resonance_script.OverfitResonanceStack(n_samples=n)
    tm = tro.OverfitResonanceStack(n, generator=torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, convert.module_to_flax(tm))
    loss_fn = script_loss(jm, jnp.asarray(target), n)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s, key):   # scripts/resonance_overfit.py:110-116
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, key)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, grads

    keys = [jax.random.fold_in(KEY, i) for i in range(2)]
    noises = [t(draws(k, (1, 4096))) for k in keys]
    p1, s1, l0, g0 = step(params, opt.init(params), keys[0])
    _, _, l1, _ = step(p1, s1, keys[1])
    lf = tro.ResonanceLoss(t(target))
    assert tro.OverfitResonanceStack(n, device="cpu").noise_shape == (1, 4096)
    trees_close(port_grads(tm, lf(tm(noises[0]))), g0["params"])
    adam = Adam(1e-3)
    state = adam.init(list(tm.parameters()))
    loss, state = tro.resonance_step(tm, adam, state, lf, noises[0])
    np.testing.assert_allclose(float(loss), float(l0), rtol=1e-5)
    got, want = flat(convert.module_to_flax(tm)["params"]), flat(p1["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * 1e-3, err_msg=k)
    run = tro.overfit_resonance(iterations=2, tiny=True, target=t(target),
                                noise=lambda i: noises[i], device="cpu", log=lambda s: None)
    np.testing.assert_allclose(run.losses, [float(l0), float(l1)], rtol=1e-5)
    assert len(run.step_starts) == 2 and run.t_end >= run.step_starts[-1]
