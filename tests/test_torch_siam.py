"""The SIAM codec's serving path (BASELINE #4) in the port against ``mptpu``
on JAX-CPU, at ``scripts/siam_overfit.py --tiny``'s size (2^13 samples, 4
events, hidden 32, context 16, STFT 512/256) with ``scripts/codec_rate.py``'s
flags: the checkpoint files, the synthetic target, ``fft_shift``, the damped
oscillator, the anti-causal encoder, the lookups, the decoder, the model's
encode and generate, the iterative decomposition, the alignment refinement,
the three streaming walks and the codec. ``mptpu``'s flax parameters cross
by ``convert.siam_from_flax``, and its noise draws (``fold_in(PRNGKey(42),
i)`` for event ``i``) are fed to the port as tensors.

Tolerances (each test names its own where it differs): frames, indices and
shifts identical; values rtol 1e-4 and an atol of 1e-6 times the
reference's largest magnitude (rendered channels 1e-4 of their largest),
the rounding of float32 FFTs and sums taken in other orders; SNR within
0.01 dB.
"""

import functools
import pickle
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from mptpu.data import synthetic as jsyn
from mptpu.gen import overfitresonance as jor
from mptpu.gen import transfer as jtransfer
from mptpu.models import inference as jinf
from mptpu.models import siam as js
from mptpu.nn import anticausal as jac
from mptpu.nn import pos_encode as jpe
from mptpu.ops import fft as jfft
from mptpu.sparse import quantize as jq
from mptpu.train import checkpoint as jckpt
from mptpu_torch import convert
from mptpu_torch.data import synthetic as tsyn
from mptpu_torch.gen import overfitresonance as tor
from mptpu_torch.gen import transfer as ttransfer
from mptpu_torch.models import inference as tinf
from mptpu_torch.models import siam as ts
from mptpu_torch.nn import anticausal as tac
from mptpu_torch.nn import pos_encode as tpe
from mptpu_torch.ops import fft as tfft
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.train import checkpoint as tckpt

N = 2**13
KEY = jax.random.PRNGKey(42)
# scripts/siam_overfit.py:347-349 (--tiny) with scripts/codec_rate.py:187-196's flags
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=4,
           transform_window_size=512, transform_step_size=256, fft_resonance=True,
           attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0,
           residual_clamp_scale=4.0, encoder_clamp=1e4)


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), np.float32)


def close(got, want, rtol=1e-4, atol_rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()))


def channels_close(got, want, rel=1e-4):
    """Rendered channels within ``rel`` of their largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_noise(key, n_events, batch=1, size=N):
    """mptpu's draws: event i's envelope noise from fold_in(key, i)."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (batch, 1, size),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(n_events)])


def snr(target, recon):
    target, recon = np.asarray(target, np.float64), np.asarray(recon, np.float64)
    return 10 * np.log10(np.sum(target**2) / np.sum((target - recon) ** 2))


@pytest.fixture
def knobs():
    """codec_rate.py's selection leak and floor (0.02) in both packages,
    restored afterwards."""
    saved = [(m, m.RELU_SELECTION_LEAK, m.RELU_SELECTION_FLOOR) for m in (jq, tq)]
    for m in (jq, tq):
        m.set_selection_leak(0.02)
        m.set_selection_floor(0.02)
    yield
    for m, leak, floor in saved:
        m.set_selection_leak(leak)
        m.set_selection_floor(floor)


def target(n=N, seed=3):
    return tsyn.synthetic_audio(n, n_events=4, seed=seed, sustained=True).reshape(1, 1, n)


def flax_tree(module):
    """The flax parameter tree of a port module (the inverse of
    convert._copy_tree): a Linear as a Dense, a Conv1d as a Conv."""
    out = {name: p.detach().numpy().copy() for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, torch.nn.Linear):
            out[name] = {"kernel": child.weight.detach().numpy().T.copy()}
            if child.bias is not None:
                out[name]["bias"] = child.bias.detach().numpy().copy()
        elif isinstance(child, torch.nn.Conv1d):
            out[name] = {"kernel": child.weight.detach().numpy().transpose(2, 1, 0).copy(),
                         "bias": child.bias.detach().numpy().copy()}
        else:
            sub = flax_tree(child)
            if sub:
                out[name] = sub
    return out


def pair(seed=1, **overrides):
    """(mptpu's model, its params, the port's model carrying them): the
    port's parameters drawn from a seeded generator, handed to mptpu as a
    flax tree (a tree from mptpu's own init is ``flax_init``'s)."""
    cfg = dict(CFG, **overrides)
    tm = ts.SIAMModel(**cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return js.SIAMModel(**cfg), {"params": flax_tree(tm)}, tm


def _one_step(module, audio, key):
    spec = module.transform(audio)
    vecs, sched = module.encode(spec)
    return module.generate(vecs, sched, key, spec)


@pytest.fixture(scope="module")
def flax_init():
    """mptpu's model.init of every layer (spectral_skip and spectral_filter
    on), jitted over one encode and generate step."""
    jm = js.SIAMModel(**dict(CFG, spectral_skip=True, spectral_filter=True))
    init = jax.jit(functools.partial(jm.init, method=_one_step))
    return init(jax.random.PRNGKey(1), jnp.asarray(target()), KEY)


# ---- rows 1 and 2: checkpoints and the synthetic target -------------------------------------


def test_checkpoint_round_trip_across_packages(tmp_path, flax_init):
    """A tree made by mptpu's model.init, saved by mptpu, loads in the port
    and carries into its model, whose parameters then equal the tree's
    (transposed where torch's layout differs) and give it back; the port's
    state_dict, saved by the port, loads in mptpu as plain numpy;
    CheckpointManager keeps the last ``keep`` and ``latest`` falls back
    past a corrupt file."""
    jckpt.save_checkpoint(str(tmp_path / "j.pkl"), flax_init, step=7)
    payload = tckpt.load_checkpoint(str(tmp_path / "j.pkl"))
    assert payload["step"] == 7 and payload["opt_state"] is None
    tm = ts.SIAMModel(**CFG, spectral_skip=True, spectral_filter=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        convert.siam_from_flax(tm, payload["params"])
    want = jax.tree_util.tree_leaves_with_path(flax_init["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(flax_tree(tm)))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))

    tckpt.save_checkpoint(str(tmp_path / "t.pkl"), tm.state_dict(), {"m": [torch.ones(2)]}, 3)
    with open(tmp_path / "t.pkl", "rb") as f:
        raw = pickle.load(f)
    assert all(type(v) is np.ndarray for v in raw["params"].values())
    assert jckpt.load_checkpoint(str(tmp_path / "t.pkl"))["step"] == 3
    np.testing.assert_array_equal(raw["opt_state"]["m"][0], np.ones(2, np.float32))

    mgr = tckpt.CheckpointManager(str(tmp_path / "run"), every=2, keep=2)
    assert not mgr.maybe_save(3, tm.state_dict())
    for step in (2, 4, 6):
        assert mgr.maybe_save(step, {"w": torch.full((2,), float(step))})
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "ckpt_000000004.pkl", "ckpt_000000006.pkl"]
    (tmp_path / "run" / "ckpt_000000008.pkl").write_bytes(b"not a pickle")
    assert mgr.latest()["step"] == 6
    assert jckpt.CheckpointManager(str(tmp_path / "run")).latest()["step"] == 6
    assert tckpt.load_checkpoint(str(tmp_path / "missing.pkl")) is None


@pytest.mark.parametrize("sustained", [False, True])
def test_synthetic_audio_is_bit_identical(sustained):
    for n, seed in ((2**13, 3), (22050 * 2, 11)):
        a = tsyn.synthetic_audio(n, n_events=6, seed=seed, sustained=sustained)
        b = jsyn.synthetic_audio(n, n_events=6, seed=seed, sustained=sustained)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn.streaming_windows(a, 2**14, 3),
                                  jsyn.streaming_windows(b, 2**14, 3))
    with pytest.raises(ValueError):
        tsyn.streaming_windows(a, 2**15, 3)


# ---- rows 3 to 6: L0 ops and the encoder -----------------------------------------------------


@pytest.mark.parametrize("n", [2**13, 2**12 + 4])
def test_fft_shift(n):
    """3x padding (24,576 samples at 2^13, not a power of two), shifts from
    0 to 1 and the fine-positioning range; rtol 1e-4, atol 1e-5 of the
    largest (the ramp's phase reaches 2.6e4 rad at shift 1)."""
    a = normal((2, 1, n), 10)
    shift = np.array([0.0, 0.0033, 0.31, 1.0], np.float32).reshape(4, 1, 1)[:, None]
    want = jfft.fft_shift(jnp.asarray(a), jnp.asarray(shift))
    close(tfft.fft_shift(t(a), t(shift)), want, atol_rel=1e-5)


def test_ends_are_real_before_each_inverse():
    """Trap (b): the three spectra of the path whose end coefficients are
    not an rFFT's own (fft_shift's ramp, SpectralResonance's Dense, the
    spectral filter) have their end imaginary parts zeroed before the
    inverse; pocketfft drops them anyway, so on the CPU every one is the
    plain inverse's float, bit for bit."""
    spec = torch.complex(t(normal((3, 17), 11)), t(normal((3, 17), 12)))
    ends = tfft.real_ends(spec)
    assert not ends.imag[:, [0, -1]].any()
    assert torch.equal(ends.imag[:, 1:-1], spec.imag[:, 1:-1]) and torch.equal(ends.real,
                                                                               spec.real)
    assert torch.equal(torch.fft.irfft(ends, n=32), torch.fft.irfft(spec, n=32))

    calls = []
    kept = (tfft.real_ends, tor.real_ends, ts.real_ends)

    def plain(s):
        calls.append(s.shape)
        return s

    tm = ts.SIAMModel(**dict(CFG, spectral_skip=True, spectral_filter=True), device="cpu")
    with torch.no_grad():
        tm.spec_filter_gate.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    x = t(target())
    noise = t(jax_noise(KEY, CFG["n_events"]))
    with torch.no_grad():
        ends_on = ts.make_iterative_fn(tm)(x, noise)
        tfft.real_ends = tor.real_ends = ts.real_ends = plain
        try:
            ends_off = ts.make_iterative_fn(tm)(x, noise)
        finally:
            tfft.real_ends, tor.real_ends, ts.real_ends = kept
    # per event: SpectralResonance, fft_shift, the spectral filter
    assert len(calls) == 3 * CFG["n_events"]
    for a, b in zip(ends_on, ends_off):
        assert torch.equal(a, b)


def test_damped_harmonic_oscillator():
    """mptpu's jitted oscillator and the port's against float64 numpy on a
    grid of 10 time units: the phase ``omega * t`` reaches 1e4 rad, where
    a float32 place of omega moves it by 1e-3 rad, so each package is held
    to float64 at 2e-3 of the largest magnitude, and to each other at the
    same."""
    rng = np.random.default_rng(13)
    shape = (3, 4, 1)
    mass = rng.uniform(0.2, 1.8, shape).astype(np.float32)
    damping = rng.uniform(15, 25, shape).astype(np.float32)
    tension = (10 ** rng.uniform(4, 8, shape)).astype(np.float32)
    disp = rng.uniform(-1, 2, shape).astype(np.float32)
    time = np.linspace(0, 10, 2048, dtype=np.float32).reshape(1, 1, -1)
    for do_clamp in (False, True):
        want = jax.jit(lambda *a: jtransfer.damped_harmonic_oscillator(
            *a, initial_velocity=0.0, do_clamp=do_clamp))(time, mass, damping, tension, disp)
        got = ttransfer.damped_harmonic_oscillator(t(time), t(mass), t(damping), t(tension),
                                                   t(disp), 0.0, do_clamp=do_clamp)
        ref = ttransfer.damped_harmonic_oscillator(*(torch.from_numpy(np.float64(a)) for a in (
            time, mass, damping, tension, disp)), 0.0, do_clamp=do_clamp).numpy()
        scale = np.abs(ref).max()
        for out in (np.asarray(want), got.numpy()):
            assert np.abs(out - ref).max() <= 2e-3 * scale
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-3 * scale


def test_pos_encode():
    """Features within 5e-3: sin(2^15 x) turns a place of the grid (which
    XLA rounds otherwise, as in test_fade_tail) into 4e-3 rad."""
    close(tpe.pos_encoded(2, 37, 16, device="cpu"), jpe.pos_encoded(2, 37, 16), atol_rel=5e-3)
    close(tpe.positional_encoding(64, 8, True, True, device="cpu"),
          jpe.positional_encoding(64, 8, True, True), atol_rel=5e-3)
    layer = jpe.LearnedPosEncodings(n_freqs=4, out_channels=6)
    x = normal((2, 10, 6), 14)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = tpe.LearnedPosEncodings(4, 6, device="cpu")
    convert._copy_tree(port, variables["params"], "")
    with torch.no_grad():
        close(port(t(x)), layer.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("variant", ["plain", "clamp", "reverse", "activation_norm",
                                     "pos_encodings"])
def test_anticausal_analysis(variant):
    """The encoder at hidden 32 over 8 dilations, mptpu's flax parameters
    carried by convert: as SIAM builds it, with a clamp of 0.5 that binds
    (the blocks reach 3; its backward is the identity), padded on the left,
    with tanh / sigmoid activation norms, and with positional encodings
    (held at 2e-4 of the largest: their features differ by up to 4e-3, see
    test_pos_encode). The input gradient matches too."""
    kw = dict(in_channels=40, channels=32, kernel_size=2, dilations=[1, 2, 4, 8, 16, 32, 64, 1],
              activation_clamp=0.5 if variant == "clamp" else 0.0,
              reverse_causality=variant == "reverse",
              with_activation_norm=variant == "activation_norm",
              pos_encodings=variant == "pos_encodings")
    jm = jac.AntiCausalAnalysis(**kw)
    x = normal((2, 40, 32), 15)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = tac.AntiCausalAnalysis(**kw, device="cpu")
    convert._copy_tree(tm, variables["params"], "")

    def jloss(v):
        return jnp.sum(jm.apply(variables, v) ** 2)

    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = tm(xt)
    atol_rel = 2e-4 if variant == "pos_encodings" else 1e-6
    close(got, want, atol_rel=atol_rel)
    if variant == "clamp":
        unclamped = jac.AntiCausalAnalysis(**dict(kw, activation_clamp=0.0))
        assert not np.allclose(unclamped.apply(variables, jnp.asarray(x)), want, atol=1e-3)
    (g,) = torch.autograd.grad(torch.sum(got**2), xt)
    close(g, jax.grad(jloss)(jnp.asarray(x)), atol_rel=max(atol_rel, 1e-5))


# ---- row 7: the decoder ----------------------------------------------------------------------


def jlookup(module, sel, items_tree, **kw):
    return module.apply({"params": items_tree} if items_tree else {}, jnp.asarray(sel), **kw)


@pytest.mark.parametrize("kind", ["lookup", "sample", "sample_flat_windowed", "envelopes",
                                  "envelopes_noise", "deformations"])
def test_lookups(kind, knobs):
    """Each Lookup kind with its items carried across, under the selection
    leak and floor (trap g: the port reads them at every call)."""
    sel = normal((2, 1, 16), 16)
    items = normal((16, 512), 17)
    noise = None
    if kind == "lookup":
        jm, tm = jor.Lookup(16, 512), tor.Lookup(16, 512, device="cpu")
    elif kind.startswith("sample"):
        kw = dict(flatten_kernel_size=64, windowed=True) if kind != "sample" else {}
        jm = jor.SampleLookup(16, 512, **kw)
        tm = tor.SampleLookup(16, 512, **kw, device="cpu")
    elif kind.startswith("envelopes"):
        noisy = kind == "envelopes_noise"
        jm = jor.Envelopes(16, 512, full_size=1024, padded_size=2048, max_events=8,
                           with_noise=noisy)
        tm = tor.Envelopes(16, 512, full_size=1024, padded_size=2048, max_events=8,
                           with_noise=noisy, device="cpu")
        noise = jax_noise(KEY, 1, batch=2, size=1024)[0] if noisy else None
    else:
        items = normal((16, 4 * 32), 17)
        jm = jor.Deformations(16, 4 * 32, full_size=512, channels=4, frames=32)
        tm = tor.Deformations(16, 4 * 32, full_size=512, channels=4, frames=32, device="cpu")
    tree = {"items": items}
    with torch.no_grad():
        tm.items.copy_(t(items))
    kw = {"key": jax.random.fold_in(KEY, 0)} if noise is not None else {}
    want = jlookup(jm, sel, tree, **kw)
    with torch.no_grad():
        got = tm(t(sel), noise=None if noise is None else t(noise))
    if kind == "deformations":
        close(got[0], want[0])
        close(got[1], want[1])
    else:
        close(got, want)
    if kind == "envelopes_noise":
        with pytest.raises(ValueError, match="noise or a generator"):
            tm(t(sel))


def test_flatten_envelope():
    x = normal((3, 1000), 18)
    close(tor.flatten_envelope(t(x), 64, 32), jor.flatten_envelope(jnp.asarray(x), 64, 32))


@pytest.mark.parametrize("fft_resonance", [True, False])
def test_overfit_resonance_model(fft_resonance, knobs):
    """The decoder alone at 2^12 samples from random heads' outputs, the
    spectral resonance and the oscillator bank (16 resonances), with
    mptpu's noise (trap a); intermediates too. A decoder given other noise
    renders another event."""
    n, frames = 2**12, 16
    kw = dict(n_noise_filters=8, noise_expressivity=4, noise_filter_samples=64,
              noise_deformations=8, instr_expressivity=4, n_events=1, n_resonances=16,
              n_envelopes=8, n_deformations=8, n_samples=n, n_frames=frames,
              samplerate=22050, hidden_channels=16, context_dim=8, fine_positioning=True,
              fft_resonance=fft_resonance)
    jm = jor.OverfitResonanceModel(**kw)
    tm = tor.OverfitResonanceModel(**kw, device="cpu")
    rng = np.random.default_rng(19)
    heads = {k: rng.standard_normal((2, 1) + shape).astype(np.float32) * 0.5
             for k, shape in tm.shape_spec.items()}
    assert tm.shape_spec == jm.shape_spec
    times = np.zeros((2, 1, frames), np.float32)
    times[0, 0, 3], times[1, 0, 9] = 0.7, 1.3
    key = jax.random.fold_in(KEY, 3)
    jheads = {k: jnp.asarray(v) for k, v in heads.items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4), jheads, jnp.asarray(times), key)
    convert._copy_tree(tm, variables["params"], "")
    want, jinter = jax.jit(jm.apply, static_argnames="return_intermediates")(
        variables, jheads, jnp.asarray(times), key, return_intermediates=True)
    noise = np.asarray(jax.random.uniform(key, (2, 1, n), minval=-1.0, maxval=1.0))
    with torch.no_grad():
        got, inter = tm({k: t(v) for k, v in heads.items()}, t(times), noise=t(noise),
                        return_intermediates=True)
        other = tm({k: t(v) for k, v in heads.items()}, t(times),
                   generator=torch.Generator().manual_seed(0))
    channels_close(got, want)
    for k in jinter:
        channels_close(inter[k], jinter[k])
    assert np.abs(other.numpy() - np.asarray(want)).max() > 0.1 * np.abs(np.asarray(want)).max()


# ---- rows 8 to 10: the model -------------------------------------------------------------------


def test_encode_and_generate_with_skip_and_filter(knobs):
    """SIAMModel.encode and generate with spectral_skip, spectral_filter
    (its gate given a non-zero kernel, so the envelope is not 1) and
    vec_clamp; the wire-side feature spec_feat gives what spec gives."""
    flags = dict(spectral_skip=True, spectral_filter=True, vec_clamp=10.0)
    jm, params, _ = pair(**flags)
    gate = params["params"]["spec_filter_gate"]
    gate["kernel"] = jnp.asarray(normal(gate["kernel"].shape, 20, 0.1))
    tm = ts.SIAMModel(**CFG, **flags, device="cpu")
    convert.siam_from_flax(tm, params)
    apply = jax.jit(jm.apply, static_argnames="method")
    spec = apply(params, jnp.asarray(target()), method=js.SIAMModel.transform)
    vecs, sched = apply(params, spec, method=js.SIAMModel.encode)
    spec_t = tm.transform(t(target()))
    close(spec_t, spec)
    tv, tsched = tm.encode(spec_t)
    close(tv, vecs)
    np.testing.assert_array_equal(tsched.detach().numpy() > 0, np.asarray(sched) > 0)
    close(tsched, sched)
    want = apply(params, vecs, sched, KEY, spec, method=js.SIAMModel.generate)
    assert not np.allclose(want, apply(params, vecs, sched, KEY, method=js.SIAMModel.generate),
                           atol=1e-4)
    with torch.no_grad():
        # mptpu's generate draws from uniform(key); the port takes those draws
        draws = t(np.asarray(jax.random.uniform(KEY, (1, 1, N), minval=-1.0, maxval=1.0)))
        got = tm.generate(t(vecs), t(sched), noise=draws, spec=spec_t)
        feat = tm.spectral_feat_static(spec_t, t(sched), CFG["in_channels"])
        by_feat = tm.generate(t(vecs), t(sched), noise=draws, spec_feat=feat)
    channels_close(got, want)
    assert torch.equal(by_feat, got)
    close(feat, js.SIAMModel.spectral_feat_static(spec, sched, CFG["in_channels"]))


def test_spectral_filter_resize_is_half_pixel_linear():
    """Trap (h): jax.image.resize(..., "linear") upsampling (257 -> 4097
    bins, as the filter does at 2^13 samples) is F.interpolate's linear
    with align_corners=False, the edge samples held."""
    env = normal((3, 257), 21) ** 2
    want = jax.image.resize(jnp.asarray(env), (3, N // 2 + 1), "linear")
    got = F.interpolate(t(env)[:, None, :], size=N // 2 + 1, mode="linear",
                        align_corners=False)[:, 0]
    close(got, want, atol_rel=1e-6)


@pytest.mark.parametrize("return_feats", [False, True])
def test_make_iterative_fn(return_feats, knobs):
    """Four steps of encode / generate / subtract, with spectral_filter on
    (so that return_feats has features to return); the module's own
    iterative() too. Frames identical."""
    flags = dict(spectral_skip=True, spectral_filter=True)
    jm, params, tm = pair(**flags)
    x = target() * np.asarray(js.fade_tail(N))
    want = jax.jit(js.make_iterative_fn(jm), static_argnames=("return_feats",))(
        params, jnp.asarray(x), KEY, return_feats=return_feats)
    noise = t(jax_noise(KEY, CFG["n_events"]))
    with torch.no_grad():
        got = ts.make_iterative_fn(tm)(t(x), noise, return_feats=return_feats)
        module = tm.iterative(t(x), noise, return_residual=True)
    assert len(got) == len(want) == 4 + return_feats
    np.testing.assert_array_equal(got[2].argmax(-1).numpy(), np.asarray(want[2]).argmax(-1))
    channels_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        close(g, w, atol_rel=1e-5)
    for a, b in zip(module, got):
        assert torch.equal(a, b)


def test_dead_switch_picks_frame_zero(knobs):
    """Trap (e): a switch that is dead everywhere (attention all 0 after
    the relu) gives frame 0 in both packages, and the floor's amplitude."""
    jm, params, tm = pair()
    sw = params["params"]["to_event_switch"]
    sw["kernel"], sw["bias"] = jnp.zeros_like(sw["kernel"]), jnp.full_like(sw["bias"], -1.0)
    convert.siam_from_flax(tm, params)
    apply = jax.jit(jm.apply, static_argnames="method")
    spec = apply(params, jnp.asarray(target()), method=js.SIAMModel.transform)
    _, sched = apply(params, spec, method=js.SIAMModel.encode)
    _, tsched = tm.encode(tm.transform(t(target())))
    assert int(np.argmax(np.asarray(sched)[0, 0])) == int(tsched[0, 0].argmax()) == 0
    close(tsched, sched)


def test_fade_tail():
    """Trap (d): ``x ** 8`` as jnp's squarings, bit for bit; the window
    within 2^-21 of mptpu's: jnp.linspace is jitted, and XLA fuses its
    float32 arithmetic into other roundings (a third of the ramp's values
    lie one place apart, eight places after the 8th power)."""
    x = np.linspace(0, 1, 999, dtype=np.float32)
    np.testing.assert_array_equal(ts._integer_pow(t(x), 8).numpy(), np.asarray(jnp.asarray(x) ** 8))
    np.testing.assert_array_equal(ts._integer_pow(t(x), 5).numpy(), np.asarray(jnp.asarray(x) ** 5))
    for n in (N, 2**17):
        np.testing.assert_allclose(ts.fade_tail(n, device="cpu").numpy(),
                                   np.asarray(js.fade_tail(n)), rtol=0, atol=2**-21)


@pytest.mark.parametrize("span", [None, N // 2])
def test_refine_event_alignment(span):
    """Shifts identical, gains and refined channels within tolerance, on
    events that are the target's parts delayed by known lags; one channel
    all zero (its lags tie: both take lag 0, trap e)."""
    rng = np.random.default_rng(22)
    parts = normal((1, 4, N), 23) * np.exp(-np.linspace(0, 6, N, dtype=np.float32))
    tgt = parts.sum(1, keepdims=True)
    lags = [5, -40, 120, 0]
    chans = np.stack([np.roll(parts[0, e], -lags[e]) for e in range(4)])[None]
    chans[0, 3] = 0.0
    chans = (chans * rng.uniform(0.5, 1.5, (1, 4, 1))).astype(np.float32)
    want = js.refine_event_alignment(jnp.asarray(tgt), jnp.asarray(chans), max_shift=128,
                                     span=span)
    got = ts.refine_event_alignment(t(tgt), t(chans), max_shift=128, span=span)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1][0, 3] == 0
    close(got[0], want[0])
    close(got[2], want[2], atol_rel=1e-5)
    close(ts.refit_event_gains(t(tgt), t(chans), span=span),
          js.refit_event_gains(jnp.asarray(tgt), jnp.asarray(chans), span=span), atol_rel=1e-5)


@pytest.mark.parametrize("mode", ["handoff", "spec", "pristine"])
def test_streaming_walk(mode, knobs):
    """The walk over 2.5 windows (three window positions) in each mode,
    with mptpu's per-window noise (fold_in(fold_in(key, w), i)); handoff
    also with fixed_noise, a refit against the target and alignment."""
    jm, params, tm = pair()
    n = N * 2 + N // 2
    audio = tsyn.synthetic_audio(n, n_events=8, seed=5, sustained=True).reshape(1, 1, n)
    windows = len(range(0, n // 256 - N // 256, N // 512))
    assert windows == 3
    noise = t(np.stack([jax_noise(jax.random.fold_in(KEY, w), CFG["n_events"])
                        for w in range(windows)]))
    want = js.streaming_encode(jm, params, jnp.asarray(audio), KEY, return_event_vectors=True,
                               mode=mode)
    got = ts.streaming_encode(tm, t(audio), noise, return_event_vectors=True, mode=mode)
    np.testing.assert_array_equal(got[2].argmax(-1).numpy(), np.asarray(want[2]).argmax(-1))
    channels_close(got[0], want[0])
    close(got[1], want[1], atol_rel=1e-5)
    channels_close(got[3], want[3])
    if mode == "handoff":   # two windows, one noise for both, refit and alignment
        audio = audio[..., : 2 * N]
        kw = dict(fixed_noise=True, refit_gains_against=jnp.asarray(audio), align_refine=64)
        want = js.streaming_encode(jm, params, jnp.asarray(audio), KEY, **kw)
        kw["refit_gains_against"] = t(audio)
        got = ts.streaming_encode(tm, t(audio), t(jax_noise(KEY, CFG["n_events"])), **kw)
        channels_close(got, want)
        with pytest.raises(ValueError, match="mode"):
            ts.streaming_encode(tm, t(audio), noise, mode="other")


# ---- row 11: the codec -----------------------------------------------------------------------


def test_codec_encode_decode_refine_embed(knobs):
    """SIAMCodec from a flax tree, with mptpu's noise (the key of
    SIAMCodec(seed=42)): encode with and without refine, decode of both,
    reconstruct with and without refit, embed. Frames and shifts
    identical, SNR within 0.01 dB; the codec's own noise draw renders
    other audio (trap a)."""
    jm, params, tm = pair()
    x = target()
    jcodec = jinf.SIAMCodec(model=jm, checkpoint_dir=None, params=params, seed=42)
    noise = t(jax_noise(KEY, CFG["n_events"]))
    codec = tinf.SIAMCodec(model=tm, checkpoint_dir=None, params=params, noise=noise)
    for refine in (False, True):
        want = jcodec.encode(jnp.asarray(x), refine=refine, max_shift=128)
        got = codec.encode(t(x), refine=refine, max_shift=128)
        np.testing.assert_array_equal(got.schedules.argmax(-1).numpy(),
                                      np.asarray(want.schedules).argmax(-1))
        channels_close(got.channels, want.channels)
        close(got.vecs, want.vecs, atol_rel=1e-5)
        if refine:
            np.testing.assert_array_equal(got.shifts.numpy(), np.asarray(want.shifts))
            close(got.gains, want.gains, atol_rel=1e-5)
        jdec, dec = np.asarray(jcodec.decode(want)), codec.decode(got).numpy()
        assert abs(snr(x, dec) - snr(x, jdec)) < 0.01
        channels_close(dec, jdec)
    for refit in (False, True):
        channels_close(codec.reconstruct(t(x), refit=refit),
                       jcodec.reconstruct(jnp.asarray(x), refit=refit))
    close(codec.embed(t(x)), jcodec.embed(jnp.asarray(x)), atol_rel=1e-5)
    # the port's state_dict round trip and a codec with its own noise draw
    again = tinf.SIAMCodec(model=ts.SIAMModel(**CFG, device="cpu"), checkpoint_dir=None,
                           params=tm.state_dict(), noise=noise)
    assert torch.equal(again.encode(t(x)).channels, got.channels)
    own = tinf.SIAMCodec(model=tm, checkpoint_dir=None, seed=42)
    assert own.noise.shape == (CFG["n_events"], 1, 1, N)
    assert not torch.allclose(own.encode(t(x)).channels, got.channels, atol=1e-4)


def test_codec_streaming_and_checkpoint_dir(tmp_path, knobs):
    """encode_streaming with mptpu's per-window noise; a codec built from
    the newest checkpoint of a directory (written by mptpu) encodes as
    one given its params."""
    jm, params, tm = pair()
    jckpt.CheckpointManager(str(tmp_path), every=1).maybe_save(5, params)
    codec = tinf.SIAMCodec(model=ts.SIAMModel(**CFG, device="cpu"), checkpoint_dir=str(tmp_path))
    for (k, a), b in zip(tm.state_dict().items(), codec.model.state_dict().values()):
        assert torch.equal(a, b), k
    n = N * 2
    audio = tsyn.synthetic_audio(n, n_events=8, seed=6, sustained=True).reshape(1, 1, n)
    noise = t(np.stack([jax_noise(jax.random.fold_in(KEY, w), CFG["n_events"])
                        for w in range(2)]))
    want = jinf.SIAMCodec(model=jm, checkpoint_dir=None, params=params,
                          seed=42).encode_streaming(jnp.asarray(audio))
    channels_close(codec.encode_streaming(t(audio), noise=noise), want)
    assert codec.encode_streaming(t(audio)).shape == (1, 1, n)


@pytest.mark.parametrize("preset", ["f16", "int8"])
def test_quantize_events(preset):
    """The wire quantization against scripts/codec_rate.py:53-76's, written
    out here in jnp (the script configures JAX when imported): the same
    floats, the same bytes per event."""
    vecs = normal((2, 5, 16), 31, 0.3)
    sched = np.zeros((2, 5, 32), np.float32)
    sched[np.arange(2)[:, None], np.arange(5)[None], np.random.default_rng(32).integers(
        0, 16, (2, 5))] = np.random.default_rng(33).uniform(0.01, 20, (2, 5))
    idx = jnp.argmax(sched, axis=-1)
    amp16 = jnp.take_along_axis(sched, idx[..., None], axis=-1).astype(jnp.float16)
    want_sched = jax.nn.one_hot(idx, 32, dtype=jnp.float32) * amp16.astype(jnp.float32)
    if preset == "f16":
        want_vecs, want_bytes = jnp.asarray(vecs).astype(jnp.float16).astype(jnp.float32), 36
    else:
        scale = jnp.maximum(jnp.max(jnp.abs(vecs), axis=-1, keepdims=True), 1e-12)
        q = jnp.clip(jnp.round(vecs / scale * 127.0), -127, 127)
        want_vecs = q / 127.0 * scale.astype(jnp.float16).astype(jnp.float32)
        want_bytes = 16 + 2 + 4
    got = tinf.quantize_events(t(vecs), t(sched), preset)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_vecs))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_sched))
    assert got[2] == want_bytes
    with pytest.raises(ValueError, match="preset"):
        tinf.quantize_events(t(vecs), t(sched), "f8")


# ---- row 12: the flax bridge -------------------------------------------------------------------


def test_siam_from_flax_skips_flagged_layers_and_refuses_the_rest(flax_init):
    """Trap (f): mptpu's tree with spec_skip_proj and spec_filter_gate
    against a model built without those flags loads with a warning naming
    both (flax ignores such leaves too) and computes as mptpu does from the
    same tree; any other extra, missing or misshapen leaf raises."""
    params = jax.tree_util.tree_map(np.asarray, flax_init)["params"]
    tm = ts.SIAMModel(**CFG, device="cpu")
    with pytest.warns(UserWarning, match="spec_filter_gate', 'spec_skip_proj"):
        convert.siam_from_flax(tm, params)
    spec = tm.transform(t(target()))
    want = js.SIAMModel(**CFG).apply({"params": params}, jnp.asarray(spec.numpy()),
                                     method=js.SIAMModel.encode)
    close(tm.encode(spec)[0], want[0])
    bad = dict(params, extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="extra"):
        convert.siam_from_flax(tm, bad)
    missing = {k: v for k, v in params.items() if k != "to_event_switch"}
    with pytest.raises(ValueError):
        convert.siam_from_flax(tm, missing)
    conv = params["encoder"]["AntiCausalStack_0"]["AntiCausalBlock_0"]["AntiCausalConv_0"]
    conv["Conv_0"]["kernel"] = np.zeros((3, 32, 32), np.float32)
    with pytest.raises(ValueError, match="Conv_0"):
        convert.siam_from_flax(tm, params)


def test_chip_smoke_siam_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 7 at the tiny size on the CPU, where the
    'card' is the CPU too: every check holds, no kernel is launched."""
    import chip_smoke

    cfg = dict(chip_smoke.SIAM, n_samples=N // 2, n_events=2, hidden=16, context_dim=8,
               window=512, walk_samples=N, audio_events=8, max_shift=64, reps=1)
    chip_smoke.siam_phase(torch.device("cpu"), cfg, lambda: None)
    assert (tq.RELU_SELECTION_LEAK, tq.RELU_SELECTION_FLOOR) == (0.0, 0.0)
