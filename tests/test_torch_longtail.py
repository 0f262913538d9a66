"""The long-tail overfit models (ROADMAP A11) in the port against ``mptpu``
on JAX-CPU: ``gen/roomsim.py`` (at ``scripts/roomsim.py``'s full
defaults), ``models/textural.py``, ``models/funcsong.py``,
``models/audiooperator.py`` and ``models/multiresolution.py``, at
``tests/test_longtail.py``'s sizes, with ``mptpu``'s parameters carried by
``convert.module_from_flax``; and one Adam step of each of the four models
against its script's jitted step (``--smoke`` sizes; roomsim has no
``--smoke`` and steps at ``test_longtail.py``'s size). The scripts' steps
live inside their ``main``, so each is restated here from its lines.

Tolerances: forward rtol 1e-5 / atol 1e-6; gradients within 1e-4 of
each leaf's largest magnitude; one Adam step's loss rtol 1e-5 and its
parameters within 1e-3 of the learning rate of optax's (Adam's first step
is about lr wherever the gradient is not 0). Wider, each measured:

- outputs made by FFTs (the textural model's audio, the room's
  recording over 512 frames, the multiresolution decoder's
  recomposition) hold at atol 1e-6 of their peak, as in
  ``test_torch_layers.py``; the room's recording read 3e-8 of its peak;
- ``band_pos_encode`` at the script's ``max_freq`` of 2,048 rad: float32
  keeps 2.4e-4 rad of such an argument, and the port's ``linspace``
  rounds the frequencies as ``jnp.linspace`` may not (one place of 2,048
  is 2.4e-4), so the encodings hold at atol 1e-3 there; the operator's
  steps take ``mptpu``'s encodings;
- ``song_pos_encoding`` at the script's 30 s song is not well conditioned
  in float32 (arguments near 2e6 rad): the steps take ``mptpu``'s
  encoding, and the test records its spread;
- ``FuncSong``'s oscillator phases reach 3e5 rad, where float32 keeps no
  digit (the two packages' float32 audio differ by 0.51 of its peak, each
  0.48 to 0.56 of it from float64): its forward, gradient and Adam step
  are held in float64 on both sides (``jax.enable_x64``), the forward at
  rtol 1e-5 / atol 1e-6 of its peak: even float64 keeps only some eight
  digits of such phases (the two packages' float64 audio read 3.4e-8 of
  the peak apart, libm's ``pow`` and ``cos`` against XLA's);
- ``envelope_loss`` is a difference of two nearly equal sums of pooled
  norms at the start: it holds at atol 1e-6 of those sums.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.data.synthetic import synthetic_audio as j_synthetic_audio
from mptpu.gen.roomsim import RoomModel as JRoomModel
from mptpu.gen.roomsim import _neighbor_average as j_neighbor_average
from mptpu.gen.roomsim import roomsim as j_roomsim
from mptpu.models import audiooperator as jao
from mptpu.models import funcsong as jfs
from mptpu.models import multiresolution as jmr
from mptpu.models import textural as jtx
from mptpu.ops.stft import stft as j_stft
from mptpu_torch import convert
from mptpu_torch.models import audiooperator as tao
from mptpu_torch.models import funcsong as tfs
from mptpu_torch.models import multiresolution as tmr
from mptpu_torch.models import textural as ttx
from mptpu_torch.train.optim import Adam

troom = importlib.import_module("mptpu_torch.gen.roomsim")   # gen's roomsim is the function

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
    want = np.asarray(want)
    close(port, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


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
    """Each leaf by :func:`leaf_close`, but for a leaf whose gradient is 0
    in exact arithmetic (the bias of a band decoder's output, whose mean
    the recomposition drops): both sides then hold float32 noise, held
    below 1e-6 of the tree's largest magnitude."""
    port, want = flat(port), flat(want)
    assert set(port) == set(want)
    floor = 1e-6 * max(np.abs(v).max() for v in want.values())
    for k in want:
        if max(np.abs(port[k]).max(), np.abs(want[k]).max()) >= floor:
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


def adam_step_close(module, j_params, j_new, lr, loss_fn, j_loss, loss_atol=0.0):
    """One step of the port's optax-form Adam from ``j_params`` (already in
    ``module``) against optax's new parameters ``j_new``."""
    params = list(module.parameters())
    adam = Adam(lr)
    state = adam.init(params)
    loss = loss_fn()
    updates, state = adam.update(torch.autograd.grad(loss, params), state)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=loss_atol)
    got, want = flat(convert.module_to_flax(module)["params"]), flat(j_new)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3 * lr, err_msg=k)
    moved = max(np.abs(want[k] - np.asarray(v)).max() for k, v in flat(j_params).items())
    assert moved > 0.5 * lr


# ---- gen/roomsim.py


def test_neighbor_average():
    for shape in [(4, 5, 6, 3), (4, 5, 6, 1), (2, 1, 3, 4)]:
        x = rand(*shape)
        close(troom._neighbor_average(t(x)), j_neighbor_average(jnp.asarray(x)))


def test_roomsim_at_the_scripts_full_defaults():
    """Block 64, 512 frames, a 5 x 17 x 9 room from ``default_rng(0)``, as
    scripts/roomsim.py builds it."""
    transfer, control = troom.room_inputs()
    want_rec, want_frames = jax.jit(j_roomsim)(jnp.asarray(transfer, jnp.float32),
                                                jnp.asarray(control))
    sim = troom.simulate_room(device="cpu", log=lambda s: None)
    assert sim.recording.shape == (512 * 64,) and sim.frames.shape == (512, 5, 17)
    close_to_peak(sim.recording, want_rec)
    close_to_peak(sim.frames, want_frames)
    assert np.abs(np.asarray(want_rec)).max() > 0


def test_room_model_forward_gradient_and_a_script_step():
    """test_longtail.py's size (3 x 3 room, 16-sample voxels, 4 frames);
    the step is scripts/roomsim.py's (mse, optax.adam(1e-2), jitted)."""
    jm = JRoomModel(room_size=3, voxel_size=16, n_frames=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = convert.module_from_flax(troom.RoomModel(3, 16, 4, device="cpu"), params)
    close_to_peak(tm(), jm.apply(params))
    target = rand(1, 1, 64, seed=1, scale=0.01)
    jloss = lambda p: jnp.mean((jm.apply(p) - target) ** 2)   # noqa: E731
    trees_close(port_grads(tm, troom.room_loss(tm, t(target))),
                jax.grad(jloss)(params)["params"])
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, s):   # scripts/roomsim.py:93-101
        loss, grads = jax.value_and_grad(jloss)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    new, _, loss = step(params, opt.init(params))
    adam_step_close(tm, params["params"], new["params"], 1e-2,
                    lambda: troom.room_loss(tm, t(target)), loss)
    fit = troom.overfit_room(t(target), 3, 16, 4, steps=2, device="cpu", log=lambda s: None)
    assert len(fit.losses) == 2 and np.isfinite(fit.losses).all()


# ---- models/textural.py

TEX_TEST = dict(n_samples=2**10, n_events=8, n_atoms=4, atom_size=64, latent_dim=4)


def test_textural_forward_and_gradient():
    jm = jtx.TexturalModel(**TEX_TEST)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = convert.module_from_flax(ttx.TexturalModel(**TEX_TEST, device="cpu"), params)
    want, want_logits = jax.jit(jm.apply)(params)
    got, logits = tm()
    assert got.shape == (1, 1, 2**10) and logits.shape == (1, 8, 10, 2)
    close_to_peak(got, want)
    close(logits, want_logits)
    target = jnp.sin(jnp.linspace(0, 60 * np.pi, 2**10)).reshape(1, 1, -1)
    ts = j_stft(target, 256, 64, pad=True)

    def j_loss(p):   # tests/test_longtail.py:205-210
        r, lg = jm.apply(p)
        return jnp.sum(jnp.abs(j_stft(r, 256, 64, pad=True) - ts)) \
            + 0.5 * jtx.confidence_loss(lg)

    from mptpu_torch.ops.stft import stft
    from mptpu_torch.ops import kinks
    r, lg = tm()
    loss = torch.sum(kinks.abs(stft(r, 256, 64, pad=True) - t(ts))) \
        + 0.5 * ttx.confidence_loss(lg)
    np.testing.assert_allclose(float(loss), float(jax.jit(j_loss)(params)), rtol=1e-5)
    trees_close(port_grads(tm, loss), jax.jit(jax.grad(j_loss))(params)["params"])


def test_confidence_loss_splits_ties_as_jnp_max():
    logits = np.array([[[[0.5, 0.5], [0.2, 0.8], [1.0, 1.0], [0.0, 2.0]]]], np.float32)
    tl = t(logits).requires_grad_()
    loss = ttx.confidence_loss(tl)
    (g,) = torch.autograd.grad(loss, tl)
    jl, jg = jax.value_and_grad(jtx.confidence_loss)(jnp.asarray(logits))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))   # halves at ties, 1.0 at the kink


def test_textural_script_step_at_smoke_size():
    """scripts/textural.py --smoke: 2^12 samples, 8 events, 8 atoms x 128,
    latent 16, lr 1e-3, confidence weight 0.5."""
    s = ttx.SMOKE
    seg = j_synthetic_audio(s["n_samples"], 22050, n_events=4, seed=0)
    np.testing.assert_array_equal(seg, ttx.textural_target(s["n_samples"]))
    target = jnp.asarray(seg).reshape(1, 1, -1)
    jm = jtx.TexturalModel(latent_dim=16, **s)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    tspec = j_stft(target, 2048, 256, pad=True)

    def loss_fn(p):   # scripts/textural.py:73-79
        recon, logits = jm.apply(p)
        rspec = j_stft(recon, 2048, 256, pad=True)
        return jnp.sum(jnp.abs(rspec - tspec)) + 0.5 * jtx.confidence_loss(logits)

    @jax.jit
    def step(p, st):   # scripts/textural.py:81-85
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, st = opt.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss

    new, _, loss = step(params, opt.init(params))
    tm = convert.module_from_flax(ttx.TexturalModel(latent_dim=16, **s, device="cpu"), params)
    tspec_t = t(tspec)
    adam_step_close(tm, params["params"], new["params"], 1e-3,
                    lambda: ttx.textural_loss(tm, tspec_t)[0], loss)
    run = ttx.train_textural(iterations=2, smoke=True, out=None, device="cpu",
                             log=lambda s: None)
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()


# ---- models/funcsong.py

FS_TEST = dict(segment_size=256, in_channels=8, hidden_channels=16, n_layers=2, n_resonances=8)


def test_song_pos_encoding_where_float32_is_well_conditioned():
    starts = np.array([0, 512, 3000], np.int32)
    want = jax.vmap(lambda s: jfs.song_pos_encoding(s, 256, 4096, 8))(jnp.asarray(starts))
    got = tfs.song_pos_encoding(torch.from_numpy(starts), 256, 4096, 8)
    assert got.shape == (3, 8, 256)
    close(got, want)
    close(tfs.song_pos_encoding(512, 256, 4096, 8, device="cpu"), want[1])


def test_song_pos_encoding_at_full_width_is_float32_noise():
    """At the script's 30 s song (661,500 samples, 256 channels, 2^15-sample
    crops) the arguments reach 2e6 rad: mptpu's jitted and eager forms
    differ by 0.249, the port's by as much, all three about 0.25 to 0.32
    from float64. So the full-width steps take mptpu's encoding."""
    total, n, c = 661500, 2**15, 256
    s = 400000
    jit = np.asarray(jax.jit(lambda v: jfs.song_pos_encoding(v, n, total, c))(jnp.int32(s)))
    eager = np.asarray(jfs.song_pos_encoding(jnp.int32(s), n, total, c))
    port = tfs.song_pos_encoding(s, n, total, c, device="cpu").numpy()
    f = 2 * np.pi
    tt = (s / total * f + n / total * f * np.linspace(0, 1, n))[None]
    fr = np.linspace(1, total // 2, c // 2)[:, None]
    f64 = np.concatenate([np.sin(tt * fr), np.cos(tt * fr)], 0)
    spreads = [np.abs(a - b).max() for a, b in ((jit, eager), (port, eager), (jit, f64),
                                                (port, f64))]
    assert all(0.1 < d < 0.5 for d in spreads), spreads


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_funcsong_forward_and_gradient_in_float64():
    """The oscillators' phases reach 3e5 rad, where float32 keeps no
    digit (mptpu's float32 forward and the port's differ by half the
    peak, each as far from float64): the packages are held to each other
    in float64, mptpu's under ``jax.enable_x64``."""
    pos = np.asarray(jax.vmap(lambda s: jfs.song_pos_encoding(s, 256, 4096, 8))(
        jnp.asarray([0, 512], jnp.int32)))
    jm = jfs.FuncSong(**FS_TEST)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(pos))
    tm = convert.module_from_flax(tfs.FuncSong(**FS_TEST, device="cpu"), params)
    assert tfs.count_parameters(tm) == jfs.count_parameters(params)
    assert tm(t(pos)).shape == (2, 1, 256)
    tm.double()
    cot = rand(2, 1, 256, seed=3).astype(np.float64)
    with jax.enable_x64(True):
        p64, x64 = f64(params), jnp.asarray(pos, jnp.float64)
        want = np.asarray(jax.jit(jm.apply)(p64, x64))
        jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, x64) * cot)))(p64)["params"]
    got = tm(torch.from_numpy(pos).double())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    trees_close(port_grads(tm, torch.sum(got * torch.from_numpy(cot))), jgrad)


def test_funcsong_script_step_at_smoke_size():
    """scripts/funcsong.py --smoke: crops of 2^11 of the 30 s synthetic song,
    8 position channels, hidden 32, 2 layers, batch 2, lr 1e-3; the crops'
    starts from ``default_rng(0)`` and the batch (crops and encodings)
    mptpu's jitted ``batch_from_starts``; the loss and the Adam step in
    float64 on both sides."""
    s = tfs.SMOKE
    song = tfs.funcsong_song()
    np.testing.assert_array_equal(song, j_synthetic_audio(661500, 22050, n_events=120, seed=0,
                                                          sustained=True))
    total, n, c = len(song), s["segment_samples"], s["pos_channels"]
    jm = jfs.FuncSong(segment_size=n, in_channels=c, hidden_channels=s["hidden"],
                      n_layers=s["layers"])
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, c, n)))
    song_dev = jnp.asarray(song)

    def batch_from_starts(starts):   # scripts/funcsong.py:101-112
        def one(st):
            seg = jax.lax.dynamic_slice(song_dev, (st,), (n,))
            return seg, jfs.song_pos_encoding(st, n, total, c)

        segs, pos = jax.vmap(one)(starts)
        return segs[:, None, :], pos

    starts = np.random.default_rng(0).integers(0, total - n, size=2)
    target, pos = jax.jit(batch_from_starts)(jnp.asarray(starts, jnp.int32))
    t_target, _ = tfs.crop_batch(torch.from_numpy(song), torch.from_numpy(starts), n, c)
    np.testing.assert_array_equal(t_target.numpy(), np.asarray(target))
    with jax.enable_x64(True):
        opt = optax.adam(1e-3)
        target64, pos64 = jnp.asarray(target, jnp.float64), jnp.asarray(pos, jnp.float64)

        def loss_fn(p):   # scripts/funcsong.py:114-119
            recon = jm.apply(p, pos64)
            return jnp.sum(jnp.abs(j_stft(recon, 2048, 256, pad=True)
                                   - j_stft(target64, 2048, 256, pad=True)))

        @jax.jit
        def train_step(p, st):   # scripts/funcsong.py:121-127
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, st = opt.update(grads, st, p)
            return optax.apply_updates(p, updates), st, loss

        p64 = f64(params)
        new, _, loss = train_step(p64, opt.init(p64))
        new, loss = jax.tree_util.tree_map(np.asarray, new), float(loss)
    tm = convert.module_from_flax(tfs.FuncSong(n, c, s["hidden"], s["layers"], device="cpu"),
                                  params).double()
    t_pos = torch.from_numpy(np.asarray(pos, np.float64))
    adam_step_close(tm, params["params"], new["params"], 1e-3,
                    lambda: tfs.funcsong_loss(tm, t_target.double(), t_pos)[0], loss)
    run = tfs.train_funcsong(iterations=2, smoke=True, out=None, device="cpu",
                             log=lambda s: None)
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()


# ---- models/audiooperator.py

AO_TEST = dict(envelope_resolution=16, latent_dim=4, pos_encoding_dim=16, model_dim=16)


def test_band_pos_encode():
    x = np.random.default_rng(0).random((2, 1, 64)).astype(np.float32)
    encode = jax.jit(jao.band_pos_encode, static_argnums=(1,), static_argnames=("max_freq",))
    close(tao.band_pos_encode(t(x), 8), encode(jnp.asarray(x), 8))
    close(tao.band_pos_encode(t(x), 512, max_freq=2048.0),
          encode(jnp.asarray(x), 512, max_freq=2048.0), rtol=0, atol=1e-3)


def pooled_norms(target, window, step):
    """The sum of the target's pooled-envelope norms: ``envelope_loss`` is
    a difference of two such sums, nearly equal while the recon is small,
    so its rounding scales with them, not with the loss."""
    pooled = torch.nn.functional.avg_pool1d(target.abs(), window, step, padding=step,
                                            count_include_pad=True)
    return float(torch.linalg.vector_norm(pooled, dim=-1).sum())


def mptpu_draws(key, n):
    """generate_training_batch's four uniform draws (audiooperator.py:67-71)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,), minval=1e-3, maxval=1.0),
            jax.random.uniform(k3, (n, 1), maxval=10.0),
            jax.random.uniform(k4, (n, 1), maxval=10.0))


def test_generate_training_batch_with_mptpus_draws():
    key = jax.random.PRNGKey(0)
    want = jax.jit(jao.generate_training_batch, static_argnums=(1, 2, 3))(key, 4, 1024, 32)
    got = tao.training_batch_from_draws(*(t(d) for d in mptpu_draws(key, 4)), 1024, 32)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-6 * float(np.abs(np.asarray(w)).max()))
    drawn = tao.generate_training_batch(torch.Generator().manual_seed(0), 4, 1024, 32,
                                        device="cpu")
    assert drawn[0].shape == (4, 1, 1024) and torch.isfinite(drawn[0]).all()


def test_audiooperator_forward_gradient_and_loss():
    key = jax.random.PRNGKey(1)
    target, starts, durs, envs = jao.generate_training_batch(key, 2, 512, 16)
    latents = np.asarray(jax.random.uniform(key, (2, 1, 4), minval=-1, maxval=1))
    times = jnp.broadcast_to(jnp.linspace(0, 1, 512).reshape(1, 1, -1), (2, 1, 512))
    te = jao.band_pos_encode(times, 8)
    es = jao.band_pos_encode(starts.reshape(-1, 1, 1), 8).reshape(2, 1, -1)
    ed = jao.band_pos_encode(durs.reshape(-1, 1, 1), 8).reshape(2, 1, -1)
    args = [np.asarray(a) for a in (es, ed, envs[:, None, :], latents, te)]
    jm = jao.AudioOperator(**AO_TEST)
    params = jax.jit(jm.init)(key, *args)
    tm = convert.module_from_flax(tao.AudioOperator(**AO_TEST, device="cpu"), params)
    want = jax.jit(jm.apply)(params, *args)
    got = tm(*(t(a) for a in args))
    close(got, want)
    loss = tao.envelope_loss(t(target), got, 64, 16)

    def j_loss(p):
        return jao.envelope_loss(target, jm.apply(p, *args), 64, 16)

    np.testing.assert_allclose(float(loss), float(j_loss(params)), rtol=1e-5,
                               atol=1e-6 * pooled_norms(t(target), 64, 16))
    trees_close(port_grads(tm, loss), jax.jit(jax.grad(j_loss))(params)["params"])


@pytest.mark.parametrize("overfit", [False, True])
def test_audiooperator_script_step_at_smoke_size(overfit):
    """scripts/audiooperator.py --smoke (2^11 samples, 16 bands, model 32,
    envelope 32, latent 8, pool 128 / 32, batch 4, lr 1e-3): the
    random-batch step (``make_batch(split(key)[1])``) and the ``--overfit``
    step (the init batch), each fed to the port as mptpu drew it."""
    s = tao.SMOKE
    n, nb, pos_dim = s["n_samples"], s["n_bands"], 2 * s["n_bands"]
    jm = jao.AudioOperator(envelope_resolution=s["envelope_resolution"],
                           latent_dim=s["latent_dim"], pos_encoding_dim=pos_dim,
                           model_dim=s["model_dim"])
    key = jax.random.PRNGKey(0)
    times = jnp.broadcast_to(jnp.linspace(0.0, 1.0, n).reshape(1, 1, -1), (4, 1, n))
    times_enc = jao.band_pos_encode(times, nb, max_freq=2048.0)

    def make_batch(k):   # scripts/audiooperator.py:80-94
        kb, kl = jax.random.split(k)
        target, starts, durs, envs = jao.generate_training_batch(kb, 4, n,
                                                                 s["envelope_resolution"])
        latents = jax.random.uniform(kl, (4, 1, s["latent_dim"]), minval=-1.0, maxval=1.0)
        es = jao.band_pos_encode(starts.reshape(-1, 1, 1), nb, max_freq=2048.0).reshape(
            4, 1, pos_dim)
        ed = jao.band_pos_encode(durs.reshape(-1, 1, 1), nb, max_freq=2048.0).reshape(
            4, 1, pos_dim)
        return target, es, ed, envs[:, None, :], latents

    def loss_fn(p, batch):   # scripts/audiooperator.py:96-101
        target, es, ed, envs, latents = batch
        recon = jm.apply(p, es, ed, envs, latents, times_enc)
        return jao.envelope_loss(target, recon, s["pool_window"], s["pool_step"])

    init_batch = jax.jit(make_batch)(key)
    params = jax.jit(jm.init)(key, *init_batch[1:], times_enc)
    opt = optax.adam(1e-3)
    batch = init_batch if overfit else jax.jit(make_batch)(jax.random.split(key)[1])

    @jax.jit
    def step(p, st, b):   # scripts/audiooperator.py:108-119
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        updates, st = opt.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss

    new, _, loss = step(params, opt.init(params), batch)
    tm = convert.module_from_flax(tao.AudioOperator(
        s["envelope_resolution"], s["latent_dim"], pos_dim, s["model_dim"], device="cpu"), params)
    t_batch = tuple(t(b) for b in batch)
    t_enc = t(times_enc)
    adam_step_close(tm, params["params"], new["params"], 1e-3,
                    lambda: tao.operator_loss(tm, t_batch, t_enc, s["pool_window"],
                                              s["pool_step"]), loss,
                    loss_atol=1e-6 * pooled_norms(t_batch[0], s["pool_window"], s["pool_step"]))
    run = tao.train_audiooperator(iterations=2, smoke=True, overfit=overfit, out=None,
                                  device="cpu", log=lambda s: None)
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()


# ---- models/multiresolution.py


def test_decoder_shell():
    """tests/test_models_extra.py:74's shell: bands 512 and 1024 of 1,024
    samples, 8 channels, latent 16."""
    kw = dict(channels=8, band_sizes=(512, 1024), n_samples=1024, latent_dim=16)
    z = rand(2, 16)
    jm = jmr.DecoderShell(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(z))
    tm = convert.module_from_flax(tmr.DecoderShell(**kw, device="cpu"), params)
    want = jax.jit(jm.apply)(params, jnp.asarray(z))
    got = tm(t(z))
    assert got.shape == (2, 1, 1024)
    close_to_peak(got, want)
    cot = rand(2, 1, 1024, seed=1)
    trees_close(port_grads(tm, torch.sum(got * t(cot))),
                jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(z)) * cot)))(
                    params)["params"])


def test_encoder_shell():
    sizes = {512: 6, 1024: 4}
    feats = {k: rand(2, 64 * 3 * v, seed=k) for k, v in sizes.items()}
    jm = jmr.EncoderShell(channels=8, band_feature_sizes=sizes, latent_dim=16)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jfeats)
    tm = convert.module_from_flax(tmr.EncoderShell(8, sizes, 16, device="cpu"), params)
    want = jax.jit(jm.apply)(params, jfeats)
    got = tm({k: t(v) for k, v in feats.items()})
    assert got.shape == (2, 16)
    close(got, want)
    cot = rand(2, 16, seed=4)
    trees_close(port_grads(tm, torch.sum(got * t(cot))),
                jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jfeats) * cot)))(
                    params)["params"])


# ---- convert.py round trips of the A11 models

MODELS = {
    "funcsong": lambda: (tfs.FuncSong(**FS_TEST, device="cpu"), jfs.FuncSong(**FS_TEST),
                         [np.zeros((1, 8, 256), np.float32)]),
    "textural": lambda: (ttx.TexturalModel(**TEX_TEST, device="cpu"),
                         jtx.TexturalModel(**TEX_TEST), []),
    "roomsim": lambda: (troom.RoomModel(3, 16, 4, device="cpu"), JRoomModel(3, 16, 4), []),
    "audiooperator": lambda: (tao.AudioOperator(**AO_TEST, device="cpu"),
                              jao.AudioOperator(**AO_TEST),
                              [np.zeros((1, 1, 16), np.float32)] * 2
                              + [np.zeros((1, 1, 16), np.float32),
                                 np.zeros((1, 1, 4), np.float32),
                                 np.zeros((1, 1, 16, 32), np.float32)]),
    "decoder_shell": lambda: (tmr.DecoderShell(8, (512, 1024), 1024, 16, device="cpu"),
                              jmr.DecoderShell(8, (512, 1024), 1024, 16),
                              [np.zeros((1, 16), np.float32)]),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_convert_round_trip(name):
    tm, jm, args = MODELS[name]()
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), *(jnp.asarray(a) for a in args))
    back = convert.module_to_flax(convert.module_from_flax(tm, params))
    assert set(back) == {"params"}
    want, got = flat(params["params"]), flat(back["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_phase_11_rehearsal_on_the_cpu():
    """chip_smoke.py's phase 11 at its rehearsal sizes on the CPU, where
    the card's side is the CPU too: every gate it runs on a card runs here,
    the trajectories against mptpu's recorded at those sizes."""
    import chip_smoke

    chip_smoke.longtail_phase(torch.device("cpu"), chip_smoke.LONGTAIL_SMALL, lambda: None)
