"""The splat overfit (BASELINE #3) in the port against ``mptpu`` on JAX-CPU,
at small sizes (2^12 samples, 4 to 8 events, context 8): the MLP heads with
flax's parameters carried across, the resonance, the schedulers, the
impulse-response bank, the event generator in both branches, the whole
model's forward and loss gradient with ``mptpu``'s parameters and noise,
three Adam steps against ``scripts/splat.py``'s jitted step, the NaN
guard, ``overfit_model`` and ``convert.splat_from_flax``'s refusals.

Tolerances (each test names its own where it differs): values and
gradients rtol 1e-4 and an atol of 1e-5 times the reference's largest
magnitude, the rounding of float32 FFTs and sums taken in other orders.
The rendered events carry ``F0Resonance``'s sines, whose phase reaches
5e4 radians at 2^12 samples; the phase is the same float32 in both
packages (``f0s`` in ``mptpu``'s order, the harmonic factors summed from
the left), so only ``sin``'s own rounding, and what the FFTs add, differs.
"""

import copy
import wave

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.gen import reds as jreds
from mptpu.gen import reverb as jreverb
from mptpu.gen import schedule as jsched
from mptpu.gen.splat import SplattingEventGenerator as JGen
from mptpu.losses import iterative_loss as j_iterative_loss
from mptpu.models import OverfitHierarchicalEvents as JModel
from mptpu.models import splat_loss_transform as j_transform
from mptpu.nn import LinearOutputStack as JStack
from mptpu.nn import MultiHeadTransform as JHeads
from mptpu.train import overfit_model as j_overfit_model
from mptpu_torch import convert
from mptpu_torch.gen import reds as treds
from mptpu_torch.gen import reverb as treverb
from mptpu_torch.gen import schedule as tsched
from mptpu_torch.gen.splat import SplattingEventGenerator as TGen
from mptpu_torch.models import OverfitHierarchicalEvents as TModel
from mptpu_torch.models import overfit_splat
from mptpu_torch.models.splat_overfit import splat_loss
from mptpu_torch.nn import LinearOutputStack as TStack
from mptpu_torch.nn import MultiHeadTransform as THeads
from mptpu_torch.train import make_train_step, optimizer, overfit_model

N = 2**12
SR = 22050


def normal(shape, seed, scale=1.0):
    return np.asarray(scale * np.random.default_rng(seed).standard_normal(shape), np.float32)


def close(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = atol_rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def flat(tree, prefix=""):
    """{"a/b/c": array} of a flax parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def torch_grads_by_flax_name(module, grads):
    """{"a/b/c": gradient} of the port's module, under flax's names (an
    ``nn.Linear`` weight as a kernel, transposed)."""
    names = {v: k for k, v in convert.SPLAT_CHILDREN.items()}
    out = {}
    for name, g in grads.items():
        parts = name.split(".")
        parts[0] = names.get(parts[0], parts[0])
        leaf = parts[-1]
        g = g.numpy()
        if leaf == "weight":
            parts[-1], g = "kernel", g.T
        out["/".join(parts)] = g
    return out


# the MLP heads ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(channels=16, layers=1, out_channels=3, in_channels=8, unit_norm_out=True),
    dict(channels=4, layers=2, out_channels=2),
    dict(channels=16, layers=2, out_channels=1, in_channels=8),
    dict(channels=8, layers=1),
    dict(channels=8, layers=1, shortcut=False, init_scale=0.5),
])
def test_linear_output_stack(kw):
    width = kw.get("in_channels") or kw["channels"]
    x = normal((2, 5, width), 1)
    jm = JStack(**kw)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = convert.splat_from_flax(TStack(**kw, device="cpu"), variables)
    if kw.get("out_channels") == 1:
        assert getattr(tm, tm.out_name).bias is None
        assert "bias" not in variables["params"][tm.out_name]
    w = normal((2, 5, kw.get("out_channels") or kw["channels"]), 3)
    want = jm.apply(variables, jnp.asarray(x))
    j_gx, j_gp = jax.grad(lambda v, p: jnp.sum(jm.apply(p, v) * w), argnums=(0, 1))(
        jnp.asarray(x), variables)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    close(got.detach().numpy(), np.asarray(want))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (xt, *params))
    close(grads[0].numpy(), np.asarray(j_gx))
    t_g = torch_grads_by_flax_name(tm, dict(zip(names, grads[1:])))
    j_g = flat(j_gp["params"])
    assert set(t_g) == set(j_g)
    for k in j_g:
        close(t_g[k], j_g[k])


def test_multihead_transform():
    shapes = dict(amp=(1,), env=(2,), verb_params=(4,), time_decays=(16,))
    x = normal((1, 6, 8), 4)
    jm = JHeads(8, hidden_channels=32, shapes=shapes, n_layers=1)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tm = convert.splat_from_flax(THeads(8, 32, shapes, 1, device="cpu"), variables)
    assert list(tm.keys()) == [f"head_{k}" for k in sorted(shapes)]
    want = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert list(got) == sorted(shapes)
    for k in shapes:
        assert tuple(got[k].shape) == (1, 6, *shapes[k])
        close(got[k].detach().numpy(), np.asarray(want[k]))


# the resonance ---------------------------------------------------------------

def test_exponential_decay():
    d = normal((1, 5, 1), 6)
    jfn = jax.jit(lambda v: jreds.exponential_decay(v, 5, 16, 0.02, N))
    want = jfn(jnp.asarray(d))
    j_g = jax.grad(lambda v: jnp.sum(jfn(v) * normal((1, 5, N), 7)))(jnp.asarray(d))
    dt = torch.from_numpy(d).requires_grad_()
    got = treds.exponential_decay(dt, 5, 16, 0.02, N)
    (t_g,) = torch.autograd.grad((got * torch.from_numpy(normal((1, 5, N), 7))).sum(), dt)
    close(got.detach().numpy(), np.asarray(want))
    close(t_g.numpy(), np.asarray(j_g))


def f0_inputs(e=6, seed=8):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(-1, 1, (1, e, 1)).astype(np.float32)
    decay = rng.standard_normal((1, e, 1)).astype(np.float32)
    spacing = rng.uniform(0.2, 1.2, (1, e, 1)).astype(np.float32)
    time_decay = (1 + 80 / (1 + np.exp(-rng.standard_normal((1, e, 16))))).astype(np.float32)
    return f0, decay, spacing, time_decay


def test_f0_resonance_phase_is_the_same_float():
    """The sines' argument is bit-identical to the one of mptpu's jitted
    F0Resonance (XLA fuses ``min + f0 * range`` into one multiply-add; the
    harmonic factors are summed from the left, as jnp.cumsum does on the
    CPU, where torch.cumsum accumulates in float64): the phase at every
    sample is then the same float32."""
    f0, decay, spacing, _ = f0_inputs()
    jres = jreds.F0Resonance(16, N)
    steps = jnp.arange(1, N + 1, dtype=jnp.float32)

    def phase(f, d, s):   # mptpu/gen/reds.py:68-87, the sine's argument
        f = (f**2).reshape(1, 6, 1)
        f = (jres.min_freq + f * jres.freq_range) * jnp.pi
        return (f * jnp.cumsum(jnp.broadcast_to(s, (1, 6, 16)), axis=-1))[..., None] * steps

    want = np.asarray(jax.jit(phase)(jnp.asarray(f0), jnp.asarray(decay), jnp.asarray(spacing)))
    seen = []
    real_sin = torch.sin
    try:   # the port's argument, taken where it reaches sin
        torch.sin = lambda v: seen.append(v) or real_sin(v)
        treds.F0Resonance(16, N)(torch.from_numpy(f0), torch.from_numpy(decay),
                                 torch.from_numpy(spacing))
    finally:
        torch.sin = real_sin
    np.testing.assert_array_equal(seen[0].numpy(), want)


@pytest.mark.parametrize("with_time_decay", [True, False])
def test_f0_resonance(with_time_decay):
    """Forward and gradient into every input. Tolerance: values atol 1e-5
    (sines differing in sin's last place, summed over 16 octaves, then
    max-normed), gradients rtol 1e-3 and an atol of 1e-4 of the largest
    (d sin / d f0 carries the sample index, up to 4,096)."""
    f0, decay, spacing, time_decay = f0_inputs()
    arrays = [f0, decay, spacing] + ([time_decay] if with_time_decay else [])
    jres, tres = jreds.F0Resonance(16, N), treds.F0Resonance(16, N)
    w = normal((1, 6, N), 9)

    def jfn(*a):
        return jres(a[0], a[1], a[2], time_decay=a[3] if with_time_decay else None)

    want = jax.jit(jfn)(*map(jnp.asarray, arrays))
    j_g = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tres(ts[0], ts[1], ts[2], time_decay=ts[3] if with_time_decay else None)
    t_g = torch.autograd.grad((got * torch.from_numpy(w)).sum(), ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for a, b in zip(t_g, j_g):
        close(a.numpy(), np.asarray(b), rtol=1e-3, atol_rel=1e-4)


# the schedulers --------------------------------------------------------------

def tree_choices(shape, seed):
    """Choices whose two entries differ by at least 0.3: no near-ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 1] = x[..., 0] + np.where(rng.random(shape[:-1]) < 0.5, -1, 1) * rng.uniform(0.3, 1.5, shape[:-1])
    return x


def test_hierarchical_dirac_forward_is_one_hot():
    """One-hot within FFT round-off (atol 1e-5), at the position mptpu
    finds; gradient against jax.grad (rtol 1e-4, atol 1e-5 of the
    largest)."""
    x = tree_choices((1, 5, 12, 2), 10)
    got = tsched.hierarchical_dirac(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jsched.hierarchical_dirac)(jnp.asarray(x)))
    assert got.shape == (1, 5, N)
    bits = np.argmax(x, axis=-1)   # level i's choice is bit 11 - i of the position
    for e in range(5):
        row = got[0, e]
        pos = int(np.argmax(row))
        assert abs(row[pos] - 1) < 1e-5 and np.abs(np.delete(row, pos)).max() < 1e-5
        assert pos == int(np.argmax(want[0, e]))
        assert pos == sum(int(b) << (11 - i) for i, b in enumerate(bits[0, e]))
    close(got, want)
    w = normal((1, 5, N), 11)
    j_g = jax.jit(jax.grad(lambda v: jnp.sum(jsched.hierarchical_dirac(v) * w)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (t_g,) = torch.autograd.grad((tsched.hierarchical_dirac(xt) * torch.from_numpy(w)).sum(), xt)
    close(t_g.numpy(), np.asarray(j_g))


def test_hierarchical_dirac_soft_and_logits():
    x = tree_choices((2, 3, 6, 2), 12)
    got, chosen = tsched.hierarchical_dirac(torch.from_numpy(x), soft=True, return_logits=True)
    want, j_chosen = jsched.hierarchical_dirac(jnp.asarray(x), soft=True, return_logits=True)
    close(got.numpy(), np.asarray(want))
    close(chosen.numpy(), np.asarray(j_chosen))


@pytest.mark.parametrize("kind", ["dirac", "fft_shift", "hierarchical"])
def test_schedulers(kind):
    e = 3
    events = normal((1, e, N), 13)
    if kind == "dirac":
        js, ts = jsched.DiracScheduler(e, N // 256, N), tsched.DiracScheduler(e, N // 256, N)
        pos = normal((1, e, N // 256), 14)
    elif kind == "fft_shift":
        js, ts = jsched.FFTShiftScheduler(e), tsched.FFTShiftScheduler(e)
        pos = np.random.default_rng(14).uniform(0, 1, (1, e, 1)).astype(np.float32)
    else:
        js, ts = jsched.HierarchicalDiracModel(e, N), tsched.HierarchicalDiracModel(e, N)
        pos = tree_choices((1, e, 12, 2), 14)
    init = ts.init_params(torch.Generator().manual_seed(0))
    assert tuple(init.shape) == ts.param_shape == js.param_shape
    w = normal((1, e, N), 15)
    jfn = jax.jit(js.schedule)
    want = jfn(jnp.asarray(pos), jnp.asarray(events))
    j_g = jax.jit(jax.grad(lambda p, v: jnp.sum(js.schedule(p, v) * w), argnums=(0, 1)))(
        jnp.asarray(pos), jnp.asarray(events))
    pt, et = (torch.from_numpy(a).requires_grad_() for a in (pos, events))
    got = ts.schedule(pt, et)
    t_g = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (pt, et))
    # the FFT shift's phase ramp reaches 2 pi * n / 2 (1.3e4 radians), where
    # a float32 place is 1e-3 radians and XLA rounds the ramp otherwise:
    # atol 1e-3 of the largest there, 1e-5 elsewhere
    atol_rel = 1e-3 if kind == "fft_shift" else 1e-5
    close(got.detach().numpy(), np.asarray(want), atol_rel=atol_rel)
    for a, b in zip(t_g, j_g):
        close(a.numpy(), np.asarray(b), rtol=1e-3, atol_rel=atol_rel)


# the impulse-response bank ---------------------------------------------------

def test_synthetic_rooms_equal_mptpu():
    np.testing.assert_array_equal(treverb.load_impulse_responses(None, N),
                                  jreverb.load_impulse_responses(None, N))
    np.testing.assert_array_equal(treverb.load_impulse_responses(None, 512, 3, normalize=True),
                                  jreverb.load_impulse_responses(None, 512, 3, normalize=True))


def write_wav(path, samples, sampwidth):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(sampwidth)
        w.setframerate(SR)
        scale = 2 ** (8 * sampwidth - 1) - 1
        w.writeframes((np.clip(samples, -1, 1) * scale).astype(f"<i{sampwidth}").tobytes())


def test_wav_bank_equal_mptpu(tmp_path, monkeypatch):
    """Two tiny stereo WAVs (16 and 32 bit, one shorter and one longer than
    the bank's length) give the same bank in both packages; the port finds
    the directory through IMPULSE_RESPONSE_PATH, as mptpu does."""
    write_wav(tmp_path / "b.wav", normal((300, 2), 16, 0.3), 2)
    write_wav(tmp_path / "a.wav", normal((700, 2), 17, 0.3), 4)
    for normalize in (False, True):
        got = treverb.load_impulse_responses(str(tmp_path), 512, normalize=normalize)
        want = jreverb.load_impulse_responses(str(tmp_path), 512, normalize=normalize)
        assert got.shape == (2, 512)
        np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("IMPULSE_RESPONSE_PATH", str(tmp_path))
    verb = treverb.ReverbGenerator(4, 2, SR, 512, device="cpu")
    np.testing.assert_array_equal(verb.verb.rooms.numpy(),
                                  jreverb.load_impulse_responses(str(tmp_path), 512))
    assert verb.n_rooms == 2


def test_dotenv_gives_the_ir_path(tmp_path, monkeypatch):
    from mptpu_torch.config import impulse_response_path

    monkeypatch.delenv("IMPULSE_RESPONSE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    assert impulse_response_path() is None
    (tmp_path / ".env").write_text("# rooms\nOTHER=1\nIMPULSE_RESPONSE_PATH = /irs\n")
    assert impulse_response_path() == "/irs"
    monkeypatch.setenv("IMPULSE_RESPONSE_PATH", "/from/env")
    assert impulse_response_path() == "/from/env"


# the event generator ---------------------------------------------------------

def generator_inputs(spec, e, seed):
    rng = np.random.default_rng(seed)
    p = {k: (0.5 * rng.standard_normal((1, e, *shape))).astype(np.float32)
         for k, shape in spec.items()}
    return p, tree_choices((1, e, 12, 2), seed + 1)


@pytest.mark.parametrize("wavetable", [False, True])
def test_splatting_event_generator(wavetable):
    """Both branches with the same parameters, times and noise (mptpu's
    draw from the key it is applied with), the reverb MLPs carried across:
    events and the gradient into every parameter and the times. Tolerance:
    values atol 1e-4 of the largest (the F0 sines, FFT convolutions of
    2^12 samples); gradients rtol 1e-3, atol 1e-4 of the largest."""
    e = 4
    kw = dict(n_samples=N, samplerate=SR, n_resonance_octaves=16, n_frames=N // 256,
              hierarchical_scheduler=True, wavetable_resonance=wavetable)
    jg = JGen(**kw)
    tg = TGen(**kw, device="cpu")
    assert tg.shape_spec == jg.shape_spec
    p, times = generator_inputs(tg.shape_spec, e, 20)
    key = jax.random.PRNGKey(3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    variables = jg.init(key, jp, jnp.asarray(times), key)
    convert.splat_from_flax(tg, variables)
    noise = np.asarray(jax.random.uniform(key, (1, 1, N), minval=-1.0, maxval=1.0))
    w = normal((1, e, N), 21)

    def j_loss(pp, tt):
        return jnp.sum(jg.apply(variables, pp, tt, key) * w)

    want = jax.jit(lambda pp, tt: jg.apply(variables, pp, tt, key))(jp, jnp.asarray(times))
    j_gp, j_gt = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(times))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tt = torch.from_numpy(times).requires_grad_()
    got = tg(tp, tt, noise=torch.from_numpy(noise))
    assert tuple(got.shape) == (1, e, N)
    close(got.detach().numpy(), np.asarray(want), rtol=0, atol_rel=1e-4)
    names = sorted(p)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), [tp[k] for k in names] + [tt],
                                allow_unused=True, materialize_grads=True)
    for k, g in zip(names, grads):   # decay_choice feeds the wavetable branch alone
        close(g.numpy(), np.asarray(j_gp[k]), rtol=1e-3, atol_rel=1e-4)
    close(grads[-1].numpy(), np.asarray(j_gt), rtol=1e-3, atol_rel=1e-4)


def test_generator_draws_its_noise():
    """Without noise, one (1, 1, n) uniform draw in [-1, 1) from the given
    generator: the same generator state gives the same events."""
    tg = TGen(N, SR, 16, N // 256, hierarchical_scheduler=True, device="cpu")
    p, times = generator_inputs(tg.shape_spec, 3, 22)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    noise = torch.rand((1, 1, N), generator=torch.Generator().manual_seed(7)) * 2.0 - 1.0
    with torch.no_grad():
        a = tg(tp, torch.from_numpy(times), generator=torch.Generator().manual_seed(7))
        b = tg(tp, torch.from_numpy(times), noise=noise)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# the whole model, its loss and its training step ------------------------------

E, C = 8, 8


@pytest.fixture(scope="module")
def carried():
    """mptpu's model and parameters, the port's model carrying them, and a
    seeded target."""
    jm = JModel(n_samples=N, samplerate=SR, n_events=E, context_dim=C)
    key = jax.random.PRNGKey(0)
    variables = jm.init(key, key)
    tm = convert.splat_from_flax(TModel(N, SR, E, C, device="cpu"), variables)
    t = np.arange(N) / SR
    target = (np.sin(2 * np.pi * 330 * t) * np.exp(-3 * t)
              + 0.1 * np.random.default_rng(30).standard_normal(N))
    target = (target / np.abs(target).max()).astype(np.float32).reshape(1, 1, N)
    return jm, variables, tm, target


def j_noise(key):
    return np.asarray(jax.random.uniform(key, (1, 1, N), minval=-1.0, maxval=1.0))


def make_j_loss(jm, target, use_iterative_loss=False):
    """scripts/splat.py:58-65."""
    def loss_fn(params, key):
        recon, vectors, times = jm.apply(params, key)
        if use_iterative_loss:
            return j_iterative_loss(target, recon, j_transform)
        summed = jnp.sum(recon, axis=1, keepdims=True)
        return jnp.sum(jnp.abs(j_transform(target) - j_transform(summed)))

    return loss_fn


def test_model_parameters_match_the_flax_tree(carried):
    jm, variables, tm, _ = carried
    j = flat(variables["params"])
    t = torch_grads_by_flax_name(tm, {n: p.detach() for n, p in tm.named_parameters()})
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_model_forward(carried):
    """Events, vectors and times with mptpu's parameters and noise.
    Tolerance: events atol 1e-4 of the largest (see the generator test)."""
    jm, variables, tm, _ = carried
    key = jax.random.PRNGKey(1)
    want = jax.jit(lambda v, k: jm.apply(v, k))(variables, key)
    with torch.no_grad():
        got = tm(noise=torch.from_numpy(j_noise(key)))
    close(got[0].numpy(), np.asarray(want[0]), rtol=0, atol_rel=1e-4)
    close(got[1].numpy(), np.asarray(want[1]))
    close(got[2].numpy(), np.asarray(want[2]))
    perturb = normal((1, 2, C), 31, 0.3)
    want = jax.jit(lambda v, k, q: jm.apply(v, k, q))(variables, key, jnp.asarray(perturb))
    with torch.no_grad():
        got = tm(noise=torch.from_numpy(j_noise(key)), perturb=torch.from_numpy(perturb))
    close(got[0].numpy(), np.asarray(want[0]), rtol=0, atol_rel=1e-4)


TIME_PARAMS = ("times", "hier_time_vectors_0", "hier_time_vectors_1")


def port_loss_and_grads(tm, target, noise, use_iterative_loss, dtype=torch.float32):
    """(loss, {flax name: gradient}) of the port's splat loss; the model
    copied to ``dtype``. The decay_choice head feeds the wavetable branch
    alone: its gradients are zeros, as in mptpu."""
    m = copy.deepcopy(tm).to(dtype)
    recon, _, _ = m(noise=torch.from_numpy(noise).to(dtype))
    loss = splat_loss(recon, torch.from_numpy(target).to(dtype), use_iterative_loss)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return float(loss), torch_grads_by_flax_name(m, {n: g.float() for n, g in zip(names, grads)})


@pytest.mark.parametrize("use_iterative_loss", [False, True])
def test_loss_value_and_grad(carried, use_iterative_loss):
    """value_and_grad of scripts/splat.py's loss against the port's loss and
    autograd, every parameter.

    Tolerances: the loss rtol 1e-4 and, for the iterative loss, which
    telescopes to the difference of two l1 norms of the target's feature,
    an atol of 1e-6 of that norm. Gradients rtol 1e-3, atol 1e-4 of each
    parameter's largest; but the times' gradients. Those are float32
    rounding noise in both packages: each is the difference of the loss's
    gradient into the schedule at the two positions a choice selects, read
    out of an FFT correlation whose rounding is larger than that
    difference (the port in float64 puts its own float32 gradients 30% to
    170% of their largest away). They are held within 4 times the port's
    own float32 rounding of them, its distance from the port in float64
    (mptpu's sits within 2.2 times it on these inputs)."""
    jm, variables, tm, target = carried
    key = jax.random.PRNGKey(2)
    j_val, j_g = jax.jit(jax.value_and_grad(make_j_loss(jm, target, use_iterative_loss)))(
        variables, key)
    noise = j_noise(key)
    loss, t_g = port_loss_and_grads(tm, target, noise, use_iterative_loss)
    _, t64 = port_loss_and_grads(tm, target, noise, use_iterative_loss, torch.float64)
    norm = float(jnp.sum(jnp.abs(j_transform(jnp.asarray(target)))))
    np.testing.assert_allclose(loss, float(j_val), rtol=1e-4, atol=1e-6 * norm)
    j_g = flat(j_g["params"])
    assert set(t_g) == set(j_g)
    for k in j_g:
        if k in TIME_PARAMS:
            floor = float(np.abs(t_g[k] - t64[k]).max())
            assert np.abs(t_g[k] - j_g[k]).max() <= 4 * floor, k
        else:
            close(t_g[k], j_g[k], rtol=1e-3, atol_rel=1e-4)


def test_three_adam_steps(carried):
    """Three steps of the port's guarded Adam against three of
    scripts/splat.py's jitted step (optax.adam(1e-3), the same guard), each
    fed the same per-step noise (fold_in(key, i)). Tolerance: losses rtol
    1e-4; parameters: 99.9% of each array within 5e-5, a twentieth of a
    step, and all within 3 lr. An Adam step moves a parameter by about
    lr = 1e-3 times m / sqrt(v), a ratio that turns a tiny gradient's
    rounding into a step of either sign. The time parameters are left out:
    their gradients are float32 noise in both packages
    (``test_loss_value_and_grad``), which Adam turns into steps of about
    lr either way; the losses after them are compared."""
    jm, variables, _, target = carried
    tm = convert.splat_from_flax(TModel(N, SR, E, C, device="cpu"), variables)
    key = jax.random.PRNGKey(0)
    loss_fn = make_j_loss(jm, target)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state, key):   # scripts/splat.py:70-81
        loss, grads = jax.value_and_grad(loss_fn)(params, key)
        updates, new_opt = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        ok = jnp.isfinite(loss)
        params = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_params, params)
        new_opt = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_opt, opt_state)
        return params, new_opt, loss

    params, opt_state = variables, opt.init(variables)
    target_t = torch.from_numpy(target)
    noise = {}

    def t_loss():
        recon, _, _ = tm(noise=noise["now"])
        return splat_loss(recon, target_t)

    t_step = make_train_step(t_loss, optimizer(tm.parameters(), lr=1e-3, b1=0.9, b2=0.999))
    for i in range(3):
        k = jax.random.fold_in(key, i)
        params, opt_state, j_val = step(params, opt_state, k)
        noise["now"] = torch.from_numpy(j_noise(k))
        t_val = t_step()
        np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-4)
    t = torch_grads_by_flax_name(tm, {n: p.detach() for n, p in tm.named_parameters()})
    j = flat(params["params"])
    for name in j:
        # every array moved but the decay_choice head's, unused by the f0 branch
        assert np.any(j[name] != flat(variables["params"])[name]) != ("head_decay_choice" in name)
        if name not in TIME_PARAMS:
            diff = np.abs(t[name] - j[name])
            assert diff.max() <= 3e-3 and (diff > 5e-5).mean() <= 1e-3, (name, diff.max())


def test_adam_matches_optax_eps_outside_sqrt():
    """torch.optim.Adam against optax.adam over five steps of seeded
    gradients, some as small as 1e-9, where eps = 1e-8 decides the step;
    and against numpy Adam with eps outside the square root of the
    bias-corrected second moment, not inside it. Tolerance rtol 1e-5 /
    atol 1e-7, a hundred-thousandth of lr = 1e-2; eps inside the root
    would move the small-gradient parameters by more than a hundred times
    that tolerance less."""
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    g = normal((5, 4, 6), 40) * np.logspace(-9, 0, 6, dtype=np.float32)
    p0 = normal((4, 6), 41)
    opt = optax.adam(lr)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_()
    topt = optimizer([tp], lr=lr, b1=b1, b2=b2)
    outside, inside = p0.astype(np.float64), p0.astype(np.float64)
    m = v = np.zeros_like(outside)
    for i in range(5):
        updates, state = opt.update(jnp.asarray(g[i]), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g[i].copy())
        topt.step()
        m = b1 * m + (1 - b1) * g[i]
        v = b2 * v + (1 - b2) * g[i].astype(np.float64) ** 2
        m_hat, v_hat = m / (1 - b1 ** (i + 1)), v / (1 - b2 ** (i + 1))
        outside = outside - lr * m_hat / (np.sqrt(v_hat) + eps)
        inside = inside - lr * m_hat / np.sqrt(v_hat + eps)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tp.detach().numpy(), outside, rtol=1e-5, atol=1e-7)
    small = np.abs(outside - inside)[:, 0]
    assert (small > 100 * 1e-7).all()


def test_guard_skips_a_non_finite_step():
    """A NaN or Inf loss leaves the parameters and Adam's state
    bit-identical, and the next finite step proceeds."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(4, 3))
    opt = optimizer([w], lr=1e-2, b1=0.9, b2=0.999)
    scale = {"now": 1.0}
    step = make_train_step(lambda: (w**2).sum() * scale["now"], opt)
    step()
    before = (w.detach().clone(), {k: v.clone() for k, v in opt.state[w].items()})
    for bad in (float("nan"), float("inf")):
        scale["now"] = bad
        assert not np.isfinite(float(step()))
        assert torch.equal(w.detach(), before[0])
        assert opt.state[w].keys() == before[1].keys()
        for k, v in before[1].items():
            assert torch.equal(opt.state[w][k], v)
        assert w.grad is None
    scale["now"] = 1.0
    step()
    assert not torch.equal(w.detach(), before[0])
    assert int(opt.state[w]["step"]) == 2


def test_overfit_model_against_mptpu():
    """A small least-squares fit through both packages' overfit_model, the
    same initial parameters: the logged losses agree (rtol 1e-4)."""
    a = normal((16, 4), 50)
    target = normal((16,), 51)
    p0 = normal((4,), 52)

    def j_loss(params, tgt, key):
        return jnp.sum((jnp.asarray(a) @ params["w"] - tgt) ** 2)

    _, j_losses = j_overfit_model({"w": jnp.asarray(p0)}, j_loss, jnp.asarray(target),
                                  n_iterations=12, lr=1e-2, log_every=3)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    seen = []
    _, t_losses = overfit_model([w], lambda tgt, gen: ((torch.from_numpy(a) @ w - tgt) ** 2).sum(),
                                torch.from_numpy(target), n_iterations=12, lr=1e-2, log_every=3,
                                after_iteration=lambda i, p, l: seen.append(i))
    assert seen == list(range(12))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)


def test_overfit_splat_few_steps():
    """The entry point on the CPU at a small size: finite losses, one per
    step (warm-up steps first), none skipped, the loss falling."""
    rng = np.random.default_rng(60)
    target = rng.standard_normal(N).astype(np.float32)
    fit = overfit_splat(target, n_events=4, event_dim=8, n_iterations=4, warmup=1, lr=1e-2,
                        device="cpu", generator=torch.Generator().manual_seed(0))
    assert len(fit.losses) == 5 and fit.skipped == 0 and fit.steps_per_sec > 0
    assert all(np.isfinite(fit.losses)) and fit.losses[-1] < fit.losses[0]
    assert isinstance(fit.model, TModel)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(N, SR, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        overfit_splat(np.zeros(N, np.float32), n_events=4, n_iterations=1)


# splat_from_flax's refusals --------------------------------------------------

def test_splat_from_flax_refuses_a_wrong_tree(carried):
    _, variables, _, _ = carried
    tm = TModel(N, SR, E, C, device="cpu")
    params = variables["params"]

    def without(tree, path):
        tree = dict(tree)
        head, *rest = path
        tree[head] = without(tree[head], rest) if rest else None
        if not rest:
            del tree[head]
        return tree

    def replaced(tree, path, value):
        tree = dict(tree)
        head, *rest = path
        tree[head] = replaced(tree[head], rest, value) if rest else value
        return tree

    dense = ["MultiHeadTransform_0", "head_amp", "Dense_0"]
    bad_trees = [
        without(params, ["times"]),                                     # a parameter missing
        dict(params, extra=np.zeros(3, np.float32)),                    # an unknown name
        without(params, ["MultiHeadTransform_0"]),                      # a module missing
        without(params, ["MultiHeadTransform_0", "head_env"]),          # a head missing
        replaced(params, ["times"], np.zeros((1, 2, 11, 2), np.float32)),   # a wrong shape
        replaced(params, dense + ["kernel"], np.zeros((8, 64), np.float32)),  # a kernel's shape
        replaced(params, dense + ["bias"], np.zeros(64, np.float32)),   # a bias's shape
        replaced(params, ["MultiHeadTransform_0", "head_amp", "Dense_1", "bias"],
                 np.zeros(1, np.float32)),                              # a bias the head lacks
        without(params, ["SplattingEventGenerator_0", "verb", "to_room", "Dense_0", "bias"]),
        replaced(params, ["event_vectors"], {"kernel": np.zeros((2, 8), np.float32)}),
    ]
    for bad in bad_trees:
        with pytest.raises(ValueError):
            convert.splat_from_flax(tm, {"params": bad})
    with pytest.raises(ValueError):   # a stack of another width
        convert.splat_from_flax(TStack(8, 1, out_channels=3, in_channels=4, device="cpu"),
                                params["MultiHeadTransform_0"]["head_env"])
