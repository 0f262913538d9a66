"""The remaining L0 ops and ``nn`` layers (ROADMAP A4) in the port against
``mptpu`` on JAX-CPU: ``nn/init.py:uniform_range_init``,
``ops/fft.py:randomize_phase``, ``gen/transfer.py:fft_convolve_correlation``
and ``make_waves_vectorized``, ``ops/features.py``, ``ops/phase.py``,
``ops/custom_grads.py`` (each custom backward), the flax layers of
``nn/layers.py`` and ``ConvUpsample``; ``test_torch_nn_stacks.py`` holds
the stacks built on them. The same numpy inputs from a seed go to both
packages, flax's parameters (and ``batch_stats``) carried by
``convert.module_from_flax``.

Tolerances: forward rtol 1e-5 / atol 1e-6; gradients within 1e-4 of
each leaf's largest magnitude; lengths, indices and each custom
gradient's integer-valued parts exact. Wider, each measured:

- FFT products (``fft_convolve_correlation`` of three inputs, whose
  outputs reach 50) hold at atol 1e-6 of their peak: an entry near 1
  there read 1.5e-5 apart, 4e-7 of the peak;
- a gradient that is 0 in exact arithmetic (a bias before a batch norm
  in training) is float32 noise on both sides, held below 1e-6 of the
  tree's largest gradient;
- the phase codec's spectrogram holds its phase channel modulo 2 pi (a
  phase on the wrap can land on either side of it), within 1e-4 rad;
  the angle of a float32 bin carries about 1e-6 rad of rounding, and the
  running sum of the recomposition adds one per frame;
- ``mfcc``'s log magnitudes hold at atol 1e-5: near-zero cepstral bins
  (1e-4) give log values whose float32 rounding reads 2e-6;
- ``schedule_atoms``' clip gradients and the phase codec's round trip
  hold at atol 1e-5, three float32 FFTs deep.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

import mptpu.nn as jnn
from mptpu.gen.transfer import fft_convolve_correlation as j_fcc
from mptpu.gen.transfer import make_waves_vectorized as j_waves
from mptpu.nn.init import uniform_range_init as j_urange
from mptpu.ops import custom_grads as jcg
from mptpu.ops import features as jfeat
from mptpu.ops import phase as jphase
from mptpu.ops.fft import randomize_phase as j_randomize_phase
from mptpu_torch import convert
from mptpu_torch import nn as tnn
from mptpu_torch.gen.transfer import fft_convolve_correlation as t_fcc
from mptpu_torch.gen.transfer import make_waves_vectorized as t_waves
from mptpu_torch.nn.init import lecun_normal, uniform_range_init
from mptpu_torch.ops import custom_grads as tcg
from mptpu_torch.ops import features as tfeat
from mptpu_torch.ops import phase as tphase
from mptpu_torch.ops.fft import randomize_phase as t_randomize_phase

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


def close(port, want, **tol):
    np.testing.assert_allclose(port.detach().numpy() if isinstance(port, torch.Tensor)
                               else np.asarray(port), np.asarray(want), **(tol or FWD))


def close_to_peak(port, want):
    """rtol 1e-5 and atol 1e-6 of ``want``'s largest magnitude: an FFT's
    output carries rounding relative to its terms, not to each entry."""
    want = np.asarray(want)
    close(port, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def leaf_close(port, want, where=""):
    """Gradients within GRAD of the leaf's largest magnitude."""
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(port - want).max() <= GRAD * scale, (
        f"{where}: {np.abs(port - want).max() / scale:.2e} of the largest")


def trees_close(port, want, prefix="", floor=None):
    """Each leaf by :func:`leaf_close`, but for a leaf whose gradient is 0
    in exact arithmetic (a bias before a batch norm in training): both
    sides then hold float32 noise, and are held below 1e-6 of the tree's
    largest magnitude instead."""
    if floor is None:
        floor = 1e-6 * max(np.abs(np.asarray(v)).max()
                           for v in jax.tree_util.tree_leaves(want))
    assert set(port) == set(want), f"{prefix}: {sorted(port)} against {sorted(want)}"
    for k in want:
        if isinstance(want[k], dict):
            trees_close(port[k], want[k], f"{prefix}/{k}", floor)
        elif max(np.abs(np.asarray(port[k])).max(), np.abs(np.asarray(want[k])).max()) < floor:
            continue
        else:
            leaf_close(port[k], want[k], f"{prefix}/{k}")


def port_grads_as_flax(module, loss):
    """The gradients of ``loss`` by ``module``'s parameters, laid out as
    its flax parameter tree."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, g in zip(shadow.parameters(), grads):
            p.copy_(g)
    return convert.module_to_flax(shadow)["params"]


def compare_module(jmod, tmod, args, rtol_fwd=None, seed=9, **apply_kw):
    """Init ``jmod`` on ``args``, carry its variables into ``tmod``, and
    compare the forward and the gradient of ``sum(out * cotangent)`` by
    the parameters (one jitted function on mptpu's side). Returns
    (mptpu's variables, the port's output)."""
    jargs = [jnp.asarray(a) for a in args]
    variables = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **apply_kw))(*jargs)
    convert.module_from_flax(tmod, variables)
    shape = jax.eval_shape(lambda v: jmod.apply(v, *jargs, **apply_kw), variables).shape
    cot = rand(*shape, seed=seed)

    @jax.jit
    def j_fwd_grad(params):
        def f(p):
            out = jmod.apply({**variables, "params": p}, *jargs, **apply_kw)
            return jnp.sum(out * jnp.asarray(cot)), out

        (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        return out, grads

    out, grads = j_fwd_grad(variables["params"])
    tout = tmod(*(t(a) for a in args))
    close(tout, out, **(rtol_fwd or {}))
    trees_close(port_grads_as_flax(tmod, torch.sum(tout * t(cot))), grads)
    return variables, tout


# ---- nn/init.py, ops/fft.py, gen/transfer.py


def test_uniform_range_init_and_lecun_normal():
    gen = torch.Generator().manual_seed(0)
    x = uniform_range_init((4000,), -2.0, 3.0, gen)
    assert x.dtype == torch.float32 and float(x.min()) >= -2.0 and float(x.max()) < 3.0
    y = np.asarray(j_urange(-2.0, 3.0)(jax.random.PRNGKey(0), (4000,)))
    assert abs(float(x.mean()) - y.mean()) < 0.1 and abs(float(x.std()) - y.std()) < 0.1
    assert torch.equal(x, uniform_range_init((4000,), -2.0, 3.0, torch.Generator().manual_seed(0)))
    k = lecun_normal((256, 512), torch.Generator().manual_seed(1))
    flax_k = np.asarray(fnn.initializers.lecun_normal()(jax.random.PRNGKey(1), (256, 512)))
    assert float(k.abs().max()) <= 2 / np.sqrt(256) / 0.87962566103423978 + 1e-6
    assert abs(float(k.std()) - flax_k.std()) < 2e-3


def test_randomize_phase_with_mptpus_draws():
    x = rand(2, 3, 64)
    key = jax.random.PRNGKey(4)
    want = j_randomize_phase(key, jnp.asarray(x))
    phases = jax.random.uniform(key, (2, 3, 33), minval=-jnp.pi, maxval=jnp.pi)
    got = t_randomize_phase(t(x), phases=t(phases))
    close(got, want, rtol=1e-5, atol=1e-5)
    drawn = t_randomize_phase(t(x), torch.Generator().manual_seed(0))
    # the magnitudes stay but at the two end bins, whose imaginary parts the inverse drops
    close(torch.abs(torch.fft.rfft(drawn))[..., 1:-1], jnp.abs(jnp.fft.rfft(x))[..., 1:-1],
          rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("correlation", [False, True])
def test_fft_convolve_correlation(correlation):
    a, b, c = rand(2, 3, 64, seed=1), rand(2, 3, 64, seed=2), rand(1, 3, 64, seed=3)
    cot = rand(2, 3, 64, seed=4)
    want = j_fcc(*(jnp.asarray(v) for v in (a, b, c)), correlation=correlation)
    ta, tb, tc = (t(v).requires_grad_() for v in (a, b, c))
    got = t_fcc(ta, tb, tc, correlation=correlation)
    close_to_peak(got, want)
    grads = torch.autograd.grad(torch.sum(got * t(cot)), (ta, tb, tc))
    jgrads = jax.grad(lambda *v: jnp.sum(j_fcc(*v, correlation=correlation) * cot),
                      argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (a, b, c)))
    for g, w in zip(grads, jgrads):
        leaf_close(g, w)


def test_make_waves_vectorized_is_mptpus():
    f0s = [55.0, 110.5, 440.0]
    np.testing.assert_array_equal(t_waves(512, f0s, 22050, device="cpu").numpy(),
                                  np.asarray(j_waves(512, f0s, 22050)))


# ---- ops/features.py


def test_amplitude_envelope():
    x = rand(2, 3, 256)
    x[0, 0, :8] = 0.0   # real zeros: |x|'s gradient at 0 is JAX's
    want = jfeat.amplitude_envelope(jnp.asarray(x), 16)
    tx = t(x).requires_grad_()
    got = tfeat.amplitude_envelope(tx, 16)
    assert got.shape == want.shape == (2, 3, 17)
    close(got, want)
    cot = rand(2, 3, 17, seed=5)
    (g,) = torch.autograd.grad(torch.sum(got * t(cot)), tx)
    leaf_close(g, jax.grad(lambda v: jnp.sum(jfeat.amplitude_envelope(v, 16) * cot))(
        jnp.asarray(x)))


def test_mfcc_and_chroma():
    spec = np.abs(rand(2, 64, 10)) + 0.1
    tx = t(spec).requires_grad_()
    got = tfeat.mfcc(tx, 12)
    close(got, jfeat.mfcc(jnp.asarray(spec), 12), rtol=1e-5, atol=1e-5)
    cot = rand(2, 12, 10, seed=6)
    (g,) = torch.autograd.grad(torch.sum(got * t(cot)), tx)
    leaf_close(g, jax.grad(lambda v: jnp.sum(jfeat.mfcc(v, 12) * cot))(jnp.asarray(spec)))
    basis = tfeat.chroma_basis(64)
    np.testing.assert_array_equal(basis, jfeat.chroma_basis(64))
    close(tfeat.chroma(t(spec), torch.from_numpy(basis)),
          jfeat.chroma(jnp.asarray(spec), jnp.asarray(basis)))


# ---- ops/phase.py


def wrapped(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def test_phase_codec_against_mptpu():
    x = rand(2, 4096, seed=7)
    close(tphase.windowed_audio(t(x), 256, 128), jphase.windowed_audio(jnp.asarray(x), 256, 128))
    spec = tphase.stft_complex(t(x), 512, 256)
    want = jphase.stft_complex(jnp.asarray(x), 512, 256)
    close(spec.real, want.real, rtol=1e-5, atol=1e-5)
    close(spec.imag, want.imag, rtol=1e-5, atol=1e-5)
    close(tphase.istft(spec), jphase.istft(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tphase.rfft_freqs(512, "cpu").numpy(),
                                  np.asarray(jphase.rfft_freqs(512)))
    codec, jcodec = tphase.AudioCodec(512, 256, device="cpu"), jphase.AudioCodec(512, 256)
    frames, jframes = codec.to_frequency_domain(t(x)), jcodec.to_frequency_domain(jnp.asarray(x))
    assert frames.shape == jframes.shape == (2, 16, 257, 2)
    close(frames[..., 0], jframes[..., 0], rtol=1e-5, atol=1e-5)
    assert wrapped(frames[..., 1], jframes[..., 1]).max() < 1e-4
    # the recomposition from the same frames, and the round trip
    close(codec.to_time_domain(torch.from_numpy(np.array(jframes))),
          jcodec.to_time_domain(jframes), rtol=1e-5, atol=1e-5)
    recon = codec.to_time_domain(frames)[0, 0, 512:3500].numpy()
    a = x[0, 512:3500]
    assert 10 * np.log10(np.sum(a**2) / np.sum((a - recon) ** 2)) > 60


def test_mag_phase_wraps_as_jnp_remainder():
    """``jnp``'s ``%`` takes the divisor's sign: negative phase advances
    wrap into [0, 2 pi), which ``torch.fmod`` would leave negative."""
    spec = (rand(1, 6, 9, seed=8) + 1j * rand(1, 6, 9, seed=9)).astype(np.complex64)
    freqs = jphase.rfft_freqs(16)
    want = jphase.mag_phase_decomposition(jnp.asarray(spec), freqs)
    got = tphase.mag_phase_decomposition(torch.from_numpy(spec), tphase.rfft_freqs(16, "cpu"))
    assert float((got[..., 1] + torch.from_numpy(np.asarray(freqs)) * 2 * np.pi).min()) >= 0
    close(got[..., 0], want[..., 0])
    assert wrapped(got[..., 1], want[..., 1]).max() < 1e-5
    close(tphase.mag_phase_recomposition(torch.from_numpy(np.array(want)),
                                         tphase.rfft_freqs(16, "cpu")).real,
          jphase.mag_phase_recomposition(want, freqs).real, rtol=1e-5, atol=1e-5)


# ---- ops/custom_grads.py: forwards and each custom backward


def test_position_render_places_as_dynamic_update_slice():
    """A start past 2 n - 48 is clamped to it; a negative start counts from
    the end of the 2 n zeros (-12 becomes 116, then 80), so its clip lands
    outside the n samples kept."""
    clips = rand(1, 3, 48, seed=10)
    pos = np.array([[0.25, 0.9, 0.0], [0.5, 1.7, -0.2]], np.float32)
    cot = rand(2, 3, 64, seed=11)
    want = jcg.position_render(jnp.asarray(pos), jnp.asarray(clips), 64)
    tc = t(clips).requires_grad_()
    got = tcg.position_render(t(pos), tc, 64)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g,) = torch.autograd.grad(torch.sum(got * t(cot)), tc)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(
        lambda c: jnp.sum(jcg.position_render(jnp.asarray(pos), c, 64) * cot))(
            jnp.asarray(clips))))
    summed = tcg.position_render(t(pos), t(clips), 64, sum_channels=True)
    close(summed, jcg.position_render(jnp.asarray(pos), jnp.asarray(clips), 64,
                                      sum_channels=True))


@pytest.mark.parametrize("trailing", [False, True])
def test_scalar_position_and_its_backward(trailing):
    pos = np.array([[0.25, 0.75, 0.0], [0.999, 0.5, 0.1]], np.float32)
    if trailing:
        pos = pos[..., None]
    cot = rand(2, 3, 16, seed=12)
    want, vjp = jax.vjp(lambda p: jcg.scalar_position(p, 16), jnp.asarray(pos))
    tp = t(pos).requires_grad_()
    got = tcg.scalar_position(tp, 16)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g,) = torch.autograd.grad(got, tp, t(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6,
                               atol=1e-6)


def test_differentiable_fft_shift_and_its_backward():
    items, pos = rand(2, 3, 32, seed=13), np.array([[[0.1]], [[0.3]]], np.float32)
    cot = rand(2, 3, 32, seed=14)
    want, vjp = jax.vjp(jcg.differentiable_fft_shift, jnp.asarray(items), jnp.asarray(pos))
    ti, tp = t(items).requires_grad_(), t(pos).requires_grad_()
    got = tcg.differentiable_fft_shift(ti, tp)
    close(got, want, rtol=1e-5, atol=1e-5)
    gi, gp = torch.autograd.grad(got, (ti, tp), t(cot))
    ji, jp = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))


def test_schedule_atoms_and_its_backward():
    n = 64
    targets = rand(2, 1, n, seed=15)
    clips = rand(2, 3, n, seed=16)
    pos = np.array([[0.25, 0.5, 0.1], [0.0, 0.7, 0.3]], np.float32)
    cot = rand(2, 3, n, seed=17)
    want, vjp = jax.vjp(lambda c, p: jcg.schedule_atoms(c, p, jnp.asarray(targets)),
                        jnp.asarray(clips), jnp.asarray(pos))
    tc, tp = t(clips).requires_grad_(), t(pos).requires_grad_()
    got = tcg.schedule_atoms(tc, tp, t(targets))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gc, gp = torch.autograd.grad(got, (tc, tp), t(cot))
    jc, jp = vjp(jnp.asarray(cot))
    # the positions' gradient is pos - argmax / n: the argmax must agree
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))
    close(gc, jc, rtol=1e-5, atol=1e-5)


def test_diff_index_and_its_backward():
    palette = np.linspace(-1.0, 1.0, 64).astype(np.float32) ** 3
    idx = np.array([0.0, 0.5, -0.5, 0.999, -1.2, 0.31], np.float32)
    cot = rand(6, seed=18)
    want, vjp = jax.vjp(jcg.diff_index, jnp.asarray(palette), jnp.asarray(idx))
    tpal, ti = t(palette).requires_grad_(), t(idx).requires_grad_()
    got = tcg.diff_index(tpal, ti)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gpal, gi = torch.autograd.grad(got, (tpal, ti), t(cot), allow_unused=True)
    jpal, ji = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    assert gpal is None and not np.asarray(jpal).any()   # no gradient for the palette


# ---- nn/layers.py


@pytest.mark.parametrize("padding,length", [("SAME", 16), ([(1, 1)], 14)])
def test_conv_transpose_lengths_and_values(padding, length):
    """flax's ``SAME`` doubles the length, ``[(1, 1)]`` gives 2 n - 2."""
    x = rand(2, 8, 3)
    jm = fnn.ConvTranspose(5, (4,), strides=(2,), padding=padding)
    tm = tnn.ConvTranspose1d(3, 5, 4, 2, padding, device="cpu")
    _, out = compare_module(jm, tm, [x])
    assert out.shape == (2, length, 5)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_and_its_running_statistics(train):
    x = rand(4, 6, 3, scale=2.0) + 0.5
    jm, tm = fnn.BatchNorm(use_running_average=not train), tnn.BatchNorm(3, device="cpu")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": rand(3, seed=1) + 1.0, "bias": rand(3, seed=2)},
                 "batch_stats": {"mean": rand(3, seed=3), "var": np.abs(rand(3, seed=4)) + 0.5}}
    convert.module_from_flax(tm, variables)
    want, updated = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    got = tm(t(x), train=train)
    close(got, want)
    stats = convert.module_to_flax(tm)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(updated["batch_stats"][k]), rtol=1e-6,
                                   atol=1e-7)
    cot = rand(4, 6, 3, seed=5)
    j_grad = jax.grad(lambda p: jnp.sum(jm.apply({**variables, "params": p}, jnp.asarray(x),
                                                 mutable=["batch_stats"])[0] * cot))(
        variables["params"])
    tm2 = convert.module_from_flax(tnn.BatchNorm(3, device="cpu"), variables)
    trees_close(port_grads_as_flax(tm2, torch.sum(tm2(t(x), train=train) * t(cot))), j_grad)


@pytest.mark.parametrize("scale_bias", [True, False])
def test_layer_norm(scale_bias):
    x = rand(2, 5, 7, scale=3.0) + 1.0
    jm = fnn.LayerNorm(use_scale=scale_bias, use_bias=scale_bias)
    tm = tnn.LayerNorm(7, use_scale=scale_bias, use_bias=scale_bias, device="cpu")
    if scale_bias:
        compare_module(jm, tm, [x])
    else:
        close(tm(t(x)), jm.apply({}, jnp.asarray(x)))
        assert tm(t(x)).abs().max() > 0 and not list(tm.parameters())


# ---- nn/upsample.py


@pytest.mark.parametrize("mode,norm", [("nearest", None), ("linear", None), ("learned", None),
                                       ("fft", None), ("nearest", "batch_norm"),
                                       ("learned", "batch_norm"), ("linear", "layer_norm")])
def test_conv_upsample(mode, norm):
    kw = dict(latent_dim=6, channels=4, start_size=4, end_size=32, mode=mode, out_channels=2,
              batch_norm=norm == "batch_norm", layer_norm=norm == "layer_norm")
    z = rand(3, 6)
    jm, tm = jnn.ConvUpsample(**kw), tnn.ConvUpsample(**kw, device="cpu")
    train = norm == "batch_norm"
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(z))
    convert.module_from_flax(tm, variables)
    if train:
        want, updated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(z))
    else:
        want = jax.jit(jm.apply)(variables, jnp.asarray(z))
    got = tm(t(z), train=train)
    assert got.shape == want.shape == (3, 2, 32)   # learned: 2 n at every layer, exactly
    close(got, want, rtol=1e-5, atol=2e-6 if mode == "fft" else 1e-6)
    if train:
        trees_close(convert.module_to_flax(tm)["batch_stats"], updated["batch_stats"])
    cot = rand(3, 2, 32, seed=1)

    def j_loss(p):
        out = jm.apply({**variables, "params": p}, jnp.asarray(z), train=train,
                       mutable=["batch_stats"])[0]
        return jnp.sum(out * cot)

    tm2 = convert.module_from_flax(tnn.ConvUpsample(**kw, device="cpu"), variables)
    trees_close(port_grads_as_flax(tm2, torch.sum(tm2(t(z), train=train) * t(cot))),
                jax.jit(jax.grad(j_loss))(variables["params"]))


def test_conv_upsample_from_a_signal():
    kw = dict(latent_dim=6, channels=4, start_size=8, end_size=32, mode="learned",
              from_latent=False)
    compare_module(jnn.ConvUpsample(**kw), tnn.ConvUpsample(**kw, device="cpu"), [rand(2, 4, 8)])
