"""The rest of the ``gen/`` zoo (ROADMAP A9a) in the port against ``mptpu``
on JAX-CPU: ``gen/{goo,waveguide,physical,recurrent,audiomodel,instrument,
lookups,event_variants,convimpulse,reds_model}.py``, each at a small size.

Both packages get the same numpy inputs and ``mptpu``'s flax parameters,
carried by ``convert.module_from_flax``; where ``mptpu`` draws noise from
a key inside a module, the port is handed that draw (``uniform(key,
shape, -1, 1)``). Every JAX call is jitted. Each forward is held, and the
gradients of ``sum(out * cotangent)`` by every parameter (and by the
inputs where a caller would train them), against ``jax.grad``.

Tolerances: float32 forwards rtol 1e-5 / atol 1e-6 of their peak, float32
gradients within 1e-4 of each leaf's largest. Where float32 is noise (the
long running sums of phase in the recurrent synth, the oscillator banks,
the instrument's positional sines at up to 0.49 pi n rad, the dithered
phase of the event variants; the spring mesh's and the waveguide's
per-sample recurrences, where XLA fuses float32 multiply-adds), both
packages run in float64 (``jax.enable_x64``): forwards rtol 1e-9 / atol
1e-12 of their peak, gradients within 1e-8 of each leaf's largest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.gen import audiomodel as jam
from mptpu.gen import convimpulse as jci
from mptpu.gen import event_variants as jev
from mptpu.gen import goo as jgoo
from mptpu.gen import instrument as jins
from mptpu.gen import lookups as jlk
from mptpu.gen import physical as jph
from mptpu.gen import recurrent as jrec
from mptpu.gen import reds_model as jreds
from mptpu.gen import waveguide as jwg
from mptpu_torch import convert
from mptpu_torch.gen import (audiomodel, convimpulse, event_variants, goo, instrument, lookups,
                             physical, recurrent, reds_model, waveguide)

F32 = dict(rtol=1e-5, atol=1e-6, grad=1e-4)
F64 = dict(rtol=1e-9, atol=1e-12, grad=1e-8)
KEY = jax.random.PRNGKey(0)


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


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def leaf_close(port, want, tol, where=""):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(port - want).max() / scale
    assert err <= tol, f"{where}: {err:.2e} of the largest (tolerance {tol:g})"


def out_close(port, want, tol):
    want = np.asarray(want)
    port = port.detach().numpy()
    assert port.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(port, want, rtol=tol["rtol"], atol=tol["atol"] * np.abs(want).max())


def draws(key, shape, x64=False):
    """``mptpu``'s noise from ``key``: uniform in [-1, 1) (float64 under
    ``x64``, as a module draws it there)."""
    with jax.enable_x64(x64):
        return np.asarray(jax.random.uniform(key, shape, minval=-1.0, maxval=1.0))


def case(jm_apply, params, tm, args, x64=False, wrt=(), port_kw=None, cot_seed=9, tol=None,
         scale_free=()):
    """Hold the port's module ``tm`` (``mptpu``'s parameters carried in)
    against ``jm_apply(params, *args)``: the forward, and the gradients of
    ``sum(out * cotangent)`` by the parameters and by the arguments at the
    indices ``wrt``. ``port_kw`` are the port's extra keywords (its
    noise). A leaf named in ``scale_free`` has a gradient of 0 in exact
    arithmetic (it scales what a unit norm then divides out), so it is
    held at the tolerance of the tree's largest gradient, not its own.
    Returns the port's output."""
    tol = tol or (F64 if x64 else F32)
    if params is not None:
        convert.module_from_flax(tm, params)
    dtype = torch.float64 if x64 else torch.float32
    tm.to(dtype)
    with jax.enable_x64(x64):
        jp = f64(params) if (x64 and params is not None) else params
        jargs = [jnp.asarray(a, jnp.float64 if x64 else jnp.float32)
                 if np.asarray(a).dtype.kind == "f" else jnp.asarray(a) for a in args]
        want = np.asarray(jax.jit(jm_apply)(jp, *jargs))
        cot = np.random.default_rng(cot_seed).standard_normal(want.shape).astype(want.dtype)
        argnums = ((0,) if params is not None else ()) + tuple(1 + i for i in wrt)
        jgrads = jax.jit(jax.grad(lambda p, *a: jnp.sum(jm_apply(p, *a) * cot),
                                  argnums=argnums))(jp, *jargs) if argnums else ()
    targs = [torch.tensor(np.asarray(a), dtype=dtype if np.asarray(a).dtype.kind == "f"
                          else None, requires_grad=i in wrt) for i, a in enumerate(args)]
    kw = {k: (torch.from_numpy(np.asarray(v)).to(dtype) if isinstance(v, np.ndarray) else v)
          for k, v in (port_kw or {}).items()}
    got = tm(*targs, **kw)
    out_close(got, want, tol)
    params_t = list(tm.parameters())
    inputs = [targs[i] for i in wrt]
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)), params_t + inputs,
                                allow_unused=True, materialize_grads=True)
    if params is not None:
        saved = [p.detach().clone() for p in params_t]
        with torch.no_grad():
            for p, g in zip(params_t, grads):
                p.copy_(g)
            tree = convert.module_to_flax(tm)["params"]
            for p, s in zip(params_t, saved):
                p.copy_(s)
        port, jtree = flat(tree), flat(jgrads[0]["params"])
        assert set(port) == set(jtree)
        largest = max(np.abs(v).max() for v in jtree.values())
        for k in jtree:
            if any(name in k for name in scale_free):
                assert np.abs(port[k] - jtree[k]).max() <= tol["grad"] * largest, k
            else:
                leaf_close(port[k], jtree[k], tol["grad"], k)
    for n, (i, g) in enumerate(zip(wrt, grads[len(params_t):])):
        leaf_close(g.numpy(), jgrads[n + (params is not None)], tol["grad"], f"input {i}")
    return got


def init(jm, *args):
    return jax.jit(jm.init)(KEY, *args)


# ---- gen/goo.py


def test_string_mesh_and_pluck_forces_are_mptpus():
    jm, tm = jgoo.string_mesh(16), goo.string_mesh(16, device="cpu")
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(goo.pluck_forces(64, 16, 5, device="cpu").numpy(),
                                  np.asarray(jgoo.pluck_forces(64, 16, 5)))


def test_goo_simulate_and_its_gradient_in_float64():
    n_steps, n_masses = 1024, 12
    forces = np.asarray(jgoo.pluck_forces(n_steps, n_masses, position=4)) * 30.0
    forces[200:210, 7] = -20.0
    mesh64 = goo.string_mesh(n_masses, dtype=torch.float64, device="cpu")

    mesh = [np.asarray(a) for a in jgoo.string_mesh(n_masses)]

    def j_sim(_, f):
        return jgoo.simulate(jgoo.SpringMesh(*[a.astype(np.float64) if a.dtype.kind == "f"
                                               else a for a in mesh]), f)

    class Sim(torch.nn.Module):
        def forward(self, f):
            return goo.simulate(mesh64, f)

    got = case(j_sim, None, Sim(), [forces], x64=True, wrt=(0,))
    assert np.abs(got.detach().numpy()[600:]).max() > 1e-6   # still ringing


def test_goo_in_float32_rings_and_stays_bounded():
    """``mptpu``'s own test of the string, on the port."""
    out = goo.simulate(goo.string_mesh(32, device="cpu"),
                       goo.pluck_forces(4096, 32, position=8, device="cpu")).numpy()
    assert out.shape == (4096,) and np.isfinite(out).all()
    assert np.abs(out[2000:]).max() > 1e-6 and np.abs(out).max() < 1e3


# ---- gen/waveguide.py


def test_waveguide_synth_delay_table():
    w = waveguide.WaveguideSynth(max_delay=8, n_samples=64, device="cpu")
    np.testing.assert_array_equal(w.delays.numpy(),
                                  np.asarray(jwg.WaveguideSynth(max_delay=8, n_samples=64).delays))


@pytest.mark.parametrize("x64", [False, True])
def test_waveguide_synth(x64):
    jw = jwg.WaveguideSynth(max_delay=64, n_samples=1024)
    args = [rand(2, 16, seed=1), rand(2, 64, 4, seed=2), rand(2, 1, seed=3), rand(2, 16, seed=4)]
    noise = draws(KEY, (2, 1, 1024), x64)
    case(lambda _, *a: jw(KEY, *a), None, waveguide.WaveguideSynth(64, 1024, device="cpu"),
         args, x64=x64, wrt=(0, 1, 2, 3), port_kw=dict(noise=noise))


def test_waveguide_synth_scan_in_float64():
    n = 384
    rng = np.random.default_rng(5)
    impulse = np.zeros(n, np.float32)
    impulse[:24] = rng.standard_normal(24)
    delay = rng.integers(-3, 60, n).astype(np.float32) + 0.7   # truncated toward zero
    damping = rng.uniform(0.8, 1.0, n).astype(np.float32)
    filter_size = rng.integers(-2, 40, n).astype(np.float32)   # clipped to [0, 32]

    class Scan(torch.nn.Module):
        def forward(self, imp, d, damp, fs):
            return waveguide.waveguide_synth_scan(imp, d, damp, fs)

    got = case(lambda _, *a: jwg.waveguide_synth_scan(*a), None, Scan(),
               [impulse, delay, damping, filter_size], x64=True, wrt=(0, 2))
    assert np.abs(got.detach().numpy()[200:]).max() > 1e-3


# ---- gen/physical.py


def test_gaussian_window():
    means, stds = rand(2, 3, 1, seed=1, scale=0.3) + 0.5, np.abs(rand(2, 3, 1, seed=2)) * 0.1
    got = physical.gaussian_window(torch.from_numpy(means), torch.from_numpy(stds), 256)
    out_close(got, jax.jit(lambda m, s: jph.gaussian_window(m, s, 256))(means, stds), F32)


@pytest.mark.parametrize("cumulative", [False, True])
@pytest.mark.parametrize("x64", [False, True])
def test_transfer_function_segment_generator(cumulative, x64):
    """The cumulative form's complex running product is held in float64
    too, against ``jax.grad``; at float32's tolerance there, since
    ``mptpu``'s ``to_complex`` casts the transfer function to complex64
    (``mptpu/ops/fft.py:36-40``) even under x64, where the port keeps the
    input's precision."""
    jm = jph.TransferFunctionSegmentGenerator(model_dim=16, n_frames=8, window_size=64,
                                              n_samples=256, cumulative=cumulative)
    x = rand(2, 16, seed=1)
    params = init(jm, x, KEY)
    tm = physical.TransferFunctionSegmentGenerator(16, 8, 64, 256, cumulative=cumulative,
                                                   device="cpu")
    case(lambda p, a: jm.apply(p, a, KEY), params, tm, [x], x64=x64, wrt=(0,),
         port_kw=dict(noise=draws(KEY, (1, 1, 256), x64)), tol=F32)


# ---- gen/recurrent.py


def test_recurrent_synth_in_float64():
    jm = jrec.RecurrentSynth(layers=2, channels=16, samples_per_frame=64, max_iter=4)
    x = rand(1, 16, seed=1)
    params = init(jm, x, jax.random.PRNGKey(2))
    tm = recurrent.RecurrentSynth(2, 16, 64, 4, device="cpu")
    key = jax.random.PRNGKey(2)
    got = case(lambda p, a: jm.apply(p, a, key), params, tm, [x], x64=True, wrt=(0,),
               port_kw=dict(noise=draws(key, tm.noise_shape(1), True)))
    assert got.shape == (1, 1, 256)


# ---- gen/audiomodel.py


@pytest.mark.parametrize("kw", [dict(), dict(constrain=True, log_frequency=True),
                                dict(complex_valued=True, constrain=True),
                                dict(amp_squared=True)], ids=["plain", "log", "complex", "amp2"])
def test_oscillator_bank_in_float64(kw):
    jm = jam.OscillatorBank(8, 16, 512, **kw)
    x = rand(2, 8, 16, seed=1)
    params = init(jm, x)
    case(jm.apply, params, audiomodel.OscillatorBank(8, 16, 512, **kw, device="cpu"), [x],
         x64=True, wrt=(0,))


def test_audio_model_in_float64():
    jm = jam.AudioModel(n_samples=1024, model_dim=16, samplerate=22050, n_frames=8,
                        n_noise_frames=16)
    x = rand(2, 16, 8, seed=1, scale=0.5)
    key = jax.random.PRNGKey(3)
    params = init(jm, x, key)
    tm = audiomodel.AudioModel(1024, 16, 22050, 8, 16, device="cpu")
    case(lambda p, a: jm.apply(p, a, key), params, tm, [x], x64=True, wrt=(0,),
         port_kw=dict(noise=draws(key, tm.noise_shape(2), True)))


# ---- gen/instrument.py


def test_instrument_stack_in_float64():
    enc, ch, frames, n, shape, layers = 16, 8, 8, 512, 4, 2
    jm = jins.InstrumentStack(enc, ch, frames, n, shape, layers)
    energy = np.abs(rand(1, 2, ch, frames, seed=1))
    transforms = [rand(1, 2, shape, 4, seed=2 + i) for i in range(layers)]
    decays = [rand(1, 2, 1, seed=5 + i) for i in range(layers)]
    mix = rand(1, 2, layers, seed=8)
    params = init(jm, energy, transforms, decays, mix)
    tm = instrument.InstrumentStack(enc, ch, frames, n, shape, layers, device="cpu")

    def j_apply(p, e, t0, t1, d0, d1, m):
        return jm.apply({"params": p["params"]["stack"]}, e, [t0, t1], [d0, d1], m)

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.stack = tm

        def forward(self, e, t0, t1, d0, d1, m):
            return self.stack(e, [t0, t1], [d0, d1], m)

    wrapped = Stack()
    convert.module_from_flax(tm, params)
    case(j_apply, {"params": {"stack": params["params"]}}, wrapped,
         [energy, *transforms, *decays, mix], x64=True, wrt=(0, 1, 3, 5))


def test_instrument_pos_encoding_at_full_width_in_float64():
    layer = instrument.InstrumentLayer(16, 8, 8, 2**15, 4, device="cpu")
    got = layer.pos_encoding(torch.device("cpu"), torch.float64).numpy()
    with jax.enable_x64(True):
        freqs = jnp.linspace(0.00001, 0.49, 16)
        tt = jnp.linspace(0, 2**15, 2**15)
        want = np.asarray(jnp.sin(tt[None, :] * freqs[:, None] * jnp.pi))
    np.testing.assert_allclose(got[0, 0], want, atol=1e-9)


# ---- gen/lookups.py


def lookup_case(jm, tm, sel, **kw):
    params = init(jm, sel)
    return case(jm.apply, params, tm, [sel], wrt=(0,), **kw)


def zero_nans(params):
    """``mptpu``'s init with its NaNs set to 0: under ``jit`` XLA's float32
    ``0 ** y`` is NaN for a non-integer ``y`` on the CPU, and a decayed
    envelope's last sample is ``linspace(1, 0)[-1] ** y`` (the port's init
    gives 0 there, the value of the power)."""
    return jax.tree_util.tree_map(lambda a: jnp.nan_to_num(a, nan=0.0), params)


def test_mptpus_decayed_inits_are_nan_at_their_last_sample():
    """Pins the divergence above: ``mptpu``'s ``SampleResonanceLookup`` and
    ``_DecayedNoiseLookup`` start with NaN items, the port's do not."""
    sel = rand(1, 2, 8, seed=1)
    items = np.asarray(init(jlk.SampleResonanceLookup(n_items=8, n_samples=256), sel)
                       ["params"]["items"])
    assert np.isnan(items[:, -1]).any() and not np.isnan(items[:, :-1]).any()
    assert torch.isfinite(lookups.SampleResonanceLookup(8, 256, device="cpu").items).all()
    assert torch.isfinite(event_variants._DecayedNoiseLookup(8, 32 * 16, frames=16,
                                                             device="cpu").items).all()


def test_sample_resonance_lookup():
    sel = rand(1, 2, 8, seed=1)
    jm = jlk.SampleResonanceLookup(n_items=8, n_samples=256)
    case(jm.apply, zero_nans(init(jm, sel)), lookups.SampleResonanceLookup(8, 256, device="cpu"),
         [sel], wrt=(0,))


def test_fft_resonance_lookup():
    sel = np.maximum(rand(1, 2, 3, 8, seed=1), 0)
    jm = jlk.FFTResonanceLookup(n_items=8, n_samples=512, window_size=64, selection_type="relu")
    got = lookup_case(jm, lookups.FFTResonanceLookup(8, 512, window_size=64, device="cpu"), sel)
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=-1), 1.0, rtol=1e-3)


@pytest.mark.parametrize("learnable", [False, True])
def test_wavetable_lookup(learnable):
    sel = rand(1, 2, 8, seed=1)
    jm = jlk.WavetableLookup(n_items=8, n_samples=16, wave_samples=1024, learnable=learnable)
    lookup_case(jm, lookups.WavetableLookup(8, 16, wave_samples=1024, learnable=learnable,
                                            device="cpu"), sel)


def test_multiband_resonance_lookup():
    sel = rand(1, 2, 8, seed=1)
    jm = jlk.MultibandResonanceLookup(n_items=8, n_samples=0, out_samples=2048)
    lookup_case(jm, lookups.MultibandResonanceLookup(8, 0, out_samples=2048, device="cpu"), sel)


def test_the_lookups_inits_draw_in_mptpus_ranges():
    fft = lookups.FFTResonanceLookup(512, 512, window_size=64, device="cpu").items
    nz = fft[fft != 0]
    assert 0.004 < nz.numel() / fft.numel() < 0.016 and nz.abs().max() <= 6
    sample = lookups.SampleResonanceLookup(8, 256, device="cpu").items
    assert sample.abs().max() <= 1 and sample[:, -1].abs().max() == 0


def test_multissm():
    jm = jlk.MultiSSM(context_dim=8, control_plane_dim=8, n_frames=16, state_dim=16,
                      window_size=32, n_models=1, n_control_planes=4, n_samples=512)
    choice = rand(1, 1, 4, seed=1)
    times = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1, 1, 16))) * 0.02
    params = init(jm, choice, times)
    tm = lookups.MultiSSM(8, 8, 16, 16, 32, 1, 4, 512, device="cpu")
    case(jm.apply, params, tm, [choice, times], wrt=(1,))


# ---- gen/event_variants.py


def test_audio_model_event_generator_in_float64():
    jm = jev.AudioModelEventGenerator(n_items=8, n_samples=1024, n_frames=16, n_events=2,
                                      context_dim=8)
    p, times, amp = rand(1, 2, 8, seed=1), rand(1, 2, 16, seed=2, scale=0.02), rand(1, 2, 1)
    params = zero_nans(init(jm, p, times, amp, KEY))
    tm = event_variants.AudioModelEventGenerator(8, 1024, 16, 2, 8, device="cpu")
    case(lambda q, *a: jm.apply(q, *a, KEY), params, tm, [p, times, amp], x64=True,
         wrt=(0, 2), port_kw=dict(noise=draws(KEY, tm.noise_shape(1), True)))


def test_wavetable_model_in_float64():
    jm = jev.WavetableModel(n_items=4, n_samples=2048, n_frames=16, n_events=1, expressivity=2,
                            wavetable_samples=2048, lowest_band=512)
    names = list(jm.shape_spec)
    p = {n: rand(1, 1, *s, seed=i, scale=0.1) for i, (n, s) in enumerate(jm.shape_spec.items())}
    times = rand(1, 1, 16, seed=20, scale=0.02)
    params = init(jm, p, times)
    tm = event_variants.WavetableModel(4, 2048, 16, 1, 2, wavetable_samples=2048,
                                       lowest_band=512, device="cpu")

    class Flat(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = tm

        def forward(self, *a):
            return self.m(dict(zip(names, a[:-1])), a[-1])

    convert.module_from_flax(tm, params)
    case(lambda q, *a: jm.apply({"params": q["params"]["m"]}, dict(zip(names, a[:-1])), a[-1]),
         {"params": {"m": params["params"]}}, Flat(), [*p.values(), times], x64=True,
         wrt=tuple(range(len(names))))


def test_simple_event_generator_in_float64():
    jm = jev.SimpleEventGenerator(context_dim=8, n_frames=16, n_samples=1024, n_events=2,
                                  channels=16)
    p, times = rand(1, 2, 8, seed=1), rand(1, 2, 16, seed=2, scale=0.02)
    params = init(jm, p, times, KEY)
    tm = event_variants.SimpleEventGenerator(8, 16, 1024, 2, 16, device="cpu")
    case(lambda q, *a: jm.apply(q, *a, KEY), params, tm, [p, times], x64=True, wrt=(0,),
         port_kw=dict(noise=draws(KEY, tm.noise_shape(1), True)))


# ---- gen/convimpulse.py and gen/reds_model.py


def test_conv_impulse_event_generator():
    """The chain's one shared bank holds the fixed waves as a buffer: no
    ``res_samples`` in either package's tree. The chain's depth mix
    (``ResonanceChain_0/Dense_0``) scales the one block's output, which a
    unit norm divides out: its gradient is 0 in exact arithmetic."""
    kw = dict(context_dim=8, impulse_size=1024, resonance_size=2048, samplerate=22050,
              n_samples=4096, total_atoms=64)
    jm = jci.ConvImpulseEventGenerator(**kw)
    vecs, times = rand(1, 1, 8, seed=1), np.abs(rand(1, 1, 16, seed=2))
    key = jax.random.PRNGKey(4)
    params = init(jm, vecs, times, key)
    assert "res_samples" not in str(jax.tree_util.tree_structure(params))
    tm = convimpulse.ConvImpulseEventGenerator(**kw, device="cpu")
    case(lambda p, *a: jm.apply(p, *a, key), params, tm, [vecs, times], wrt=(0,),
         port_kw=dict(noise=draws(key, tm.noise_shape(1))),
         scale_free=("['ResonanceChain_0']['Dense_0']",))


def test_reds_like_model_f0_in_float64():
    """Held in float64, as is the wavetable branch below: the F0 stack's
    phase reaches 1e3 rad at 1,024 samples and the placement's phase ramp
    (``fft_shift``) as much, where float32 keeps about 6e-5 rad and the two
    packages' float32 outputs stand 1e-5 of their peak apart."""
    reds_case(False, x64=True)


def test_reds_like_model_wavetables():
    """``mptpu``'s ``shape_spec`` gives ``f0_choice`` one entry in both
    branches, which its wavetable branch cannot multiply into the
    (n_wavetable_resonances, n_samples) table; the port's gives it
    ``n_wavetable_resonances``, the width that branch takes."""
    kw = dict(n_samples=1024, use_wavetables=True, n_wavetable_resonances=64)
    jm = jreds.RedsLikeModel(**kw)
    p = {n: jnp.zeros((1, 1, *s)) for n, s in jm.shape_spec.items()}
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jm.init(KEY, p, KEY))
    assert reds_model.RedsLikeModel(**kw, device="cpu").shape_spec["f0_choice"] == (64,)
    reds_case(True, x64=True)


@pytest.mark.parametrize("which", ["conv_impulse", "reds_wavetables"])
def test_a_held_wave_table_builds_the_same_generator(which):
    """A generator given ``make_waves``' table of its f0s renders what one
    that builds the table renders, bit for bit (same seed, same noise)."""
    from mptpu_torch.gen.transfer import make_waves
    from mptpu_torch.utils.music import musical_scale_hz

    size = 2048 if which == "conv_impulse" else 1024
    table = make_waves(size, musical_scale_hz(21, 106, 16).tolist(), 22050, device="cpu")
    if which == "conv_impulse":
        kw = dict(context_dim=8, impulse_size=1024, resonance_size=2048, samplerate=22050,
                  n_samples=4096, total_atoms=64, device="cpu")
        build = lambda **w: convimpulse.ConvImpulseEventGenerator(  # noqa: E731
            **kw, generator=torch.Generator().manual_seed(3), **w)
        args = [torch.from_numpy(rand(1, 1, 8, seed=1)),
                torch.from_numpy(np.abs(rand(1, 1, 16, seed=2)))]
        call = lambda m: m(*args, noise=torch.from_numpy(rand(1, 1024, seed=3)))  # noqa: E731
    else:
        kw = dict(n_samples=1024, use_wavetables=True, n_wavetable_resonances=64, device="cpu")
        build = lambda **w: reds_model.RedsLikeModel(  # noqa: E731
            **kw, generator=torch.Generator().manual_seed(3), **w)
        spec = build().shape_spec
        p = {n: torch.from_numpy(rand(1, 2, *sh, seed=i, scale=0.5))
             for i, (n, sh) in enumerate(spec.items())}
        call = lambda m: m(p, noise=torch.from_numpy(rand(1, 1, 1024, seed=9)))  # noqa: E731
    with torch.no_grad():
        assert torch.equal(call(build(waves=table)), call(build()))


def reds_case(wavetables, x64):
    kw = dict(n_resonance_octaves=4, n_samples=1024, use_wavetables=wavetables,
              n_wavetable_resonances=64)
    jm = jreds.RedsLikeModel(**kw)
    tm = reds_model.RedsLikeModel(**kw, device="cpu")
    names = list(tm.shape_spec)
    p = {n: rand(1, 2, *s, seed=i, scale=0.5) for i, (n, s) in enumerate(tm.shape_spec.items())}
    params = init(jm, p, KEY)

    class Flat(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = tm

        def forward(self, *a, noise):
            return self.m(dict(zip(names, a)), noise=noise)

    convert.module_from_flax(tm, params)
    case(lambda q, *a: jm.apply({"params": q["params"]["m"]}, dict(zip(names, a)), KEY),
         {"params": {"m": params["params"]}}, Flat(), list(p.values()), x64=x64,
         wrt=tuple(range(len(names))), port_kw=dict(noise=draws(KEY, (1, 1, 1024), x64)))


# ---- the packages' exports

# names of mptpu.gen, mptpu.train and mptpu.losses deliberately left unported, each with the
# ROADMAP item that ports it: none is left (what A9b ports lives in mptpu.data, mptpu.utils,
# mptpu.config, mptpu.obs and scripts/)
UNPORTED = {}


@pytest.mark.parametrize("package", ["gen", "train", "losses"])
def test_every_mptpu_export_resolves_in_the_port(package):
    """Every name of ``mptpu.<package>.__all__`` (and ``mptpu.losses``' lazy
    ``make_gan_steps`` and ``gan_cycle``) resolves in the port's package,
    and stands in the port's ``__all__``."""
    import importlib

    want = importlib.import_module(f"mptpu.{package}")
    port = importlib.import_module(f"mptpu_torch.{package}")
    names = set(want.__all__) | ({"make_gan_steps", "gan_cycle"} if package == "losses" else set())
    missing = sorted(n for n in names - set(UNPORTED) if not hasattr(port, n))
    assert not missing, f"mptpu.{package} names missing in the port: {missing}"
    assert names - set(UNPORTED) <= set(port.__all__)
