"""Whole-song splatting (``mptpu/models/songsplat.py``, ``scripts/songsplat.py``)
in the port against ``mptpu`` on JAX-CPU, at the script's ``--tiny`` size
(a 2^15-sample song, 2^12-sample segments, 16 events a second: 23 events
over 128 frames, a range-query capacity of 8), ``mptpu``'s parameters
carried by ``convert.songsplat_from_flax`` and its noise draws fed in
(``fold_in(key, i)`` at step ``i``): the song and the segment stream, the
range query on a dense window at the reference size (34 of 190 events in
range, capacity 32; ``torch.topk`` orders those ties otherwise), the
forward, ``value_and_grad`` of the script's loss with and without the
sparsity term, three Adam steps against optax, ``generate_random`` with
its draws, the whole-song render with and without the gain refit, the
out-of-range error, and ``train_songsplat`` end to end with its
checkpoint, ``resume`` and ``render_only``.

Tolerances: indices, masks, counts, start frames and the song identical;
events within 1e-5 of their largest (measured 1.7e-6); the loss rtol 1e-5
(4e-7). Gradients: ``mptpu``'s float32 gradients into the resonance's f0
heads, its time decays and its reverb stand 4e-4 to 1.7e-3 of their
largest from the port's float64 (XLA fuses the phase arithmetic), and the
times' are float32 noise on both sides (5.9e-4 between the port's float32
and float64); so each parameter's gradient is held within 1e-4 of its
largest plus twice ``mptpu``'s distance from the port in float64, and
that distance within 3e-3. Parameters after Adam steps: 99.9% of each
array within 5e-5 and all within 3e-3 (a step is lr = 1e-3; Adam makes a
near-zero gradient's rounding a full step either way), the times left to
the losses after them. The render within 1e-4 of its largest; SNR within
0.01 dB, LSD within 0.01 dB or 1e-3 of itself (near-silent renders of an
untrained model read about 60 dB, and the log of float32-rounded quiet bins
moves that by 2e-4 of itself).
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mptpu.models.songsplat import SongSplatModel as JModel
from mptpu.ops.refit import refit_gains as j_refit_gains
from mptpu_torch import convert
from mptpu_torch.models import songsplat as tss
from mptpu_torch.models.songsplat import SongSplatModel as TModel
from mptpu_torch.train.optim import Adam

ROOT = Path(__file__).resolve().parent.parent
TOTAL, SEG, EPS, CAP = 2**15, 2**12, 16.0, 8
KEY = jax.random.PRNGKey(0)


def load_script():
    """scripts/songsplat.py as a module (its entry point stays under the
    __main__ check)."""
    spec = importlib.util.spec_from_file_location("songsplat", ROOT / "scripts" / "songsplat.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SCRIPT = load_script()


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work (the suite may run in
    six test processes on one machine)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def port_model(**kw):
    return TModel(TOTAL, SEG, events_per_second=EPS, events_per_segment=CAP, device="cpu", **kw)


@pytest.fixture(scope="module")
def carried():
    """mptpu's model and parameters (the script's jitted init), the port's
    model carrying them, the script's synthetic song and mptpu's jitted
    apply."""
    jm = JModel(total_samples=TOTAL, n_segment_samples=SEG, events_per_second=EPS,
                events_per_segment=CAP)
    variables = jax.jit(jm.init)(KEY, jnp.array(jm.segment_frames), KEY)
    tm = convert.songsplat_from_flax(port_model(), variables)
    song = SCRIPT.get_song(None, TOTAL, 22050)
    return jm, variables, tm, song, jax.jit(jm.apply)


def j_noise(key):
    return np.array(jax.random.uniform(key, (1, 1, 2 * SEG), minval=-1.0, maxval=1.0))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def port_by_flax_name(module, tensors):
    """{flax path: array} of the port's parameters or gradients."""
    paths = convert.flax_paths(module)
    back = {v: k for k, v in convert.SONGSPLAT_CHILDREN.items()}
    out = {}
    for name, t in tensors.items():
        path = list(paths[name])
        path[0] = back.get(path[0], path[0])
        arr = t.detach().double().numpy()
        out["/".join(path)] = arr.T if path[-1] == "kernel" else arr
    return out


def segment(song, start_frame):
    s = start_frame * 256
    return song[s: s + SEG].reshape(1, 1, -1)


# ---- the song, the stream, the parameters -------------------------------------------------------

def test_song_and_segment_stream_are_the_scripts(carried):
    jm, _, tm, song, _ = carried
    np.testing.assert_array_equal(tss.get_song(None, TOTAL, 22050), song)
    want = SCRIPT.segment_stream(song, jm, seed=5)
    got = tss.segment_stream(torch.from_numpy(song), tm, seed=5)
    for _ in range(20):
        (jx, jf), (tx, tf) = next(want), next(got)
        assert tf == jf and tm.start_range()[0] <= tf < tm.start_range()[1]
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_parameters_carry_both_ways(carried):
    _, variables, tm, _, _ = carried
    want = flat(variables["params"])
    got = port_by_flax_name(tm, dict(tm.named_parameters()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = flat(convert.songsplat_to_flax(tm)["params"])
    assert set(back) == set(want) and all(np.array_equal(back[k], want[k]) for k in want)
    assert (tm.total_events, tm.total_frames, tm.segment_frames) == (23, 128, 16)


# ---- the range query -----------------------------------------------------------------------------

def test_range_query_on_a_dense_window_keeps_lax_top_ks_ties():
    """The reference size (190 events over 2,048 frames, capacity 32) with
    34 events' hard times inside the window of start frame 1,000: the
    indices, the mask and the true count of mptpu's range query. Every
    score is 0 or 1: torch.topk returned other events for the same ties."""
    jm = JModel(total_samples=2**19, n_segment_samples=2**15, events_per_second=8.0,
                events_per_segment=32)
    rng = np.random.default_rng(7)
    times = rng.uniform(-0.01, 0.01, (190, 2048)).astype(np.float32)
    times[:, 872:1128] -= 1.0   # nothing in the window but the chosen
    dense = rng.choice(190, 34, replace=False)
    times[dense, rng.integers(872, 1128, 34)] = 1.0
    params = {"params": {"events": np.zeros((190, 32), np.float32), "times": times}}
    idx, mask, count = jm.apply(params, jnp.array(1000), method=JModel.range_query)
    tm = TModel(2**19, 2**15, device="cpu")
    with torch.no_grad():
        tm.times.copy_(torch.from_numpy(times))
    t_idx, t_mask, t_count = tm.range_query(1000)
    assert int(count) == int(t_count) == 34
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    assert t_mask.all() and t_idx.tolist() == sorted(dense.tolist())[:32]


def test_out_of_range_start_frame_raises_mptpus_error(carried):
    jm, variables, tm, _, _ = carried
    for bad in (15, 113):
        with pytest.raises(ValueError) as want:
            jm.apply(variables, bad, KEY)
        with pytest.raises(ValueError) as got:
            tm(bad, noise=torch.zeros(1, 1, 2 * SEG))
        assert str(got.value) == str(want.value)
    short = TModel(2**12, 2**12, device="cpu")
    with pytest.raises(ValueError, match="at least two segments"):
        short(16, noise=torch.zeros(1, 1, 2**13))


# ---- forward, loss, gradient, Adam ---------------------------------------------------------------

def test_forward(carried):
    """Events, mask, schedules and count at start frame 40."""
    jm, variables, tm, _, apply = carried
    key = jax.random.fold_in(KEY, 3)
    want = apply(variables, jnp.array(40), key)
    with torch.no_grad():
        got = tm(40, noise=torch.from_numpy(j_noise(key)))
    w = np.asarray(want[0])
    assert got[0].shape == w.shape == (1, CAP, SEG)
    assert np.abs(got[0].numpy() - w).max() <= 1e-5 * np.abs(w).max()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])
    dead = got[0][0][~got[1]]
    assert (dead == 0).all()


def j_loss_fn(jm, target):
    """scripts/songsplat.py:loss_fn, the sparsity weight an argument."""
    def loss_fn(params, start_frame, key, sparsity):
        rendered, mask, sched, n_in_range = jm.apply(params, start_frame, key)
        recon = jnp.sum(rendered, axis=1, keepdims=True)
        loss = jnp.abs(SCRIPT.spec_transform(recon) - SCRIPT.spec_transform(target)).sum()
        return loss + sparsity * jnp.sum(sched)
    return loss_fn


def port_grads(tm, target, start_frame, noise, sparsity, dtype):
    m = convert.songsplat_from_flax(port_model(), convert.songsplat_to_flax(tm)).to(dtype)
    loss, _, _ = tss.songsplat_loss(m, torch.from_numpy(target).to(dtype), start_frame,
                                    torch.from_numpy(noise).to(dtype), sparsity)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), port_by_flax_name(m, dict(zip(names, grads)))


@pytest.mark.parametrize("sparsity", [0.0, 1e-3])
def test_loss_value_and_grad(carried, sparsity):
    """The script's loss and its gradient into every parameter (the
    tolerance rule in the module's docstring)."""
    jm, variables, tm, song, _ = carried
    target = segment(song, 40)
    key = jax.random.fold_in(KEY, 4)
    j_val, j_g = jax.jit(jax.value_and_grad(j_loss_fn(jm, jnp.asarray(target))))(
        variables, jnp.array(40), key, jnp.float32(sparsity))
    noise = j_noise(key)
    loss, g32 = port_grads(tm, target, 40, noise, sparsity, torch.float32)
    _, g64 = port_grads(tm, target, 40, noise, sparsity, torch.float64)
    np.testing.assert_allclose(loss, float(j_val), rtol=1e-5)
    j_g = flat(j_g["params"])
    assert set(g32) == set(j_g)
    for k, want in j_g.items():
        scale = np.abs(want).max()
        jax_noise = np.abs(g64[k] - want).max()
        assert jax_noise <= 3e-3 * scale, (k, jax_noise / scale)
        assert np.abs(g32[k] - want).max() <= 1e-4 * scale + 2 * jax_noise, k


def test_three_adam_steps_against_optax(carried):
    """Three steps of the script's train_step (optax.adam(1e-3)) against
    songsplat_step, on the script's segment stream with fold_in(key, i)'s
    noise: each step's loss rtol 1e-4, the parameters after them."""
    jm, variables, _, song, _ = carried
    tm = convert.songsplat_from_flax(port_model(), variables)
    opt = optax.adam(1e-3)
    params, opt_state = variables, opt.init(variables)
    adam = Adam(1e-3)
    t_state = adam.init(list(tm.parameters()))
    stream = SCRIPT.segment_stream(song, jm)

    @jax.jit
    def train_step(params, opt_state, target, start_frame, key):   # the script's
        loss, grads = jax.value_and_grad(j_loss_fn(jm, target))(
            params, start_frame, key, jnp.float32(0.0))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(3):
        target, start_frame = next(stream)
        key = jax.random.fold_in(KEY, i)
        params, opt_state, j_val = train_step(params, opt_state, target, jnp.array(start_frame),
                                              key)
        loss, _, _, t_state = tss.songsplat_step(
            tm, adam, t_state, torch.from_numpy(np.array(target)), start_frame,
            torch.from_numpy(j_noise(key)))
        np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-4)
    got = port_by_flax_name(tm, dict(tm.named_parameters()))
    start = flat(variables["params"])
    for name, want in flat(params["params"]).items():
        if name == "times":
            continue
        moved = np.any(want != start[name])
        assert moved == ("head_decay_choice" not in name), name
        diff = np.abs(got[name] - want)
        assert diff.max() <= 3e-3 and (diff > 5e-5).mean() <= 1e-3, (name, diff.max())


# ---- the preview and the whole-song render ----------------------------------------------------

def test_generate_random_with_mptpus_draws(carried):
    """generate_random with the permutation, the logits and the noise of
    mptpu's split key."""
    jm, variables, tm, _, _ = carried
    key = jax.random.fold_in(KEY, 2_000_100)
    want = np.asarray(jax.jit(lambda v, k: jm.apply(v, k, method=JModel.generate_random))(
        variables, key))
    k1, k2, k3 = jax.random.split(key, 3)
    perm = torch.from_numpy(np.array(jax.random.permutation(k1, 23)))
    raw = torch.from_numpy(np.array(jax.random.uniform(k2, (8, 32), minval=-1.0, maxval=1.0)))
    with torch.no_grad():
        got = tm.generate_random(perm=perm, raw=raw, noise=torch.from_numpy(j_noise(k3))).numpy()
    assert got.shape == want.shape == (1, 8, SEG)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with torch.no_grad():
        own = tm.generate_random(generator=torch.Generator().manual_seed(1))
    assert own.shape == (1, 8, SEG) and torch.isfinite(own).all()


def j_render_song(jm, variables, apply, song, refit):
    """scripts/songsplat.py:204-250: the tiled render, the refit, SNR and LSD."""
    recon = np.zeros(TOTAL, np.float32)
    f = jm.segment_frames
    for sf in range(f, jm.total_frames - f, f):
        rendered = apply(variables, jnp.array(sf), jax.random.fold_in(KEY, 100000 + sf))[0]
        tgt = jnp.asarray(segment(song, sf))
        if refit:
            g = j_refit_gains(tgt, rendered[..., : tgt.shape[-1]], ridge=refit)
            seg = np.asarray(jnp.einsum("be,ben->bn", g, rendered)[0]).reshape(-1)
        else:
            seg = np.asarray(jnp.sum(rendered, axis=1)[0]).reshape(-1)
        recon[sf * 256: sf * 256 + len(seg)] = seg
    lo, hi = f * 256, (jm.total_frames - f) * 256
    t_cov, r_cov = song[lo:hi], recon[lo:hi]
    snr = float(10 * np.log10((np.sum(t_cov**2) + 1e-12) / (np.sum((t_cov - r_cov) ** 2) + 1e-12)))
    ts = jnp.abs(SCRIPT.spec_transform(jnp.asarray(t_cov).reshape(1, 1, -1)))
    rs = jnp.abs(SCRIPT.spec_transform(jnp.asarray(r_cov).reshape(1, 1, -1)))
    lsd = float(jnp.sqrt(jnp.mean((20 * jnp.log10(ts + 1e-8) - 20 * jnp.log10(rs + 1e-8)) ** 2)))
    return recon, snr, lsd


@pytest.mark.parametrize("refit", [0.0, 1e-3])
def test_render_song(carried, refit):
    jm, variables, tm, song, apply = carried
    want, snr, lsd = j_render_song(jm, variables, apply, song, refit)

    def noise(sf):
        return torch.from_numpy(j_noise(jax.random.fold_in(KEY, 100000 + sf)))

    got, metrics = tss.render_song(tm, song, refit, noise=noise, device="cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert abs(metrics["covered_snr_db"] - snr) <= 0.01
    # an untrained model renders near silence, an LSD near 60 dB, where the
    # log of float32-rounded quiet bins moves it by 2e-4 of itself
    assert abs(metrics["covered_lsd_db"] - lsd) <= max(0.01, 1e-3 * lsd)
    assert metrics["covered_samples"] == (128 - 32) * 256


# ---- the trainer ------------------------------------------------------------------------------

def test_train_songsplat_resume_and_render_only(tmp_path, carried):
    """--tiny for 3 steps, logging every step: the log lines, every step's
    loss, the dashboard, the checkpoint (which mptpu's model applies), the
    artifacts; then --resume to 5 steps and --render-only."""
    jm, _, _, _, apply = carried
    out = str(tmp_path / "run")
    lines = []
    run = tss.train_songsplat(iterations=3, tiny=True, out=out, log_every=1, device="cpu",
                              log=lines.append)
    n_params = sum(np.size(v) for v in jax.tree_util.tree_leaves(carried[1]))
    assert lines[0] == (f"song 32768 samples, 23 events, {n_params} params, compression ratio "
                        f"{jm.compression_ratio:.4f}")
    assert [ln.split(" loss")[0] for ln in lines[1:4]] == ["iter 0", "iter 1", "iter 2"]
    assert run.losses == pytest.approx(run.step_losses) and len(run.step_starts) == 3
    assert np.isfinite(run.losses).all()
    with open(os.path.join(out, "song_eval.json")) as f:
        ev = json.load(f)
    assert set(ev) == {"covered_snr_db", "covered_lsd_db", "covered_samples", "total_samples",
                       "iterations", "trained_steps", "refit_ridge", "final_loss"}
    assert (ev["trained_steps"], ev["final_loss"]) == (3, run.losses[-1])
    assert os.path.exists(os.path.join(out, "song_recon.wav"))
    assert sorted(run.model.state_dict()) == sorted(tss.SongSplatModel(
        TOTAL, SEG, events_per_second=EPS, events_per_segment=CAP, device="cpu").state_dict())

    payload = tss.CheckpointManager(out).latest()
    assert payload["step"] == 2
    tree = jax.tree_util.tree_map(jnp.asarray, payload["params"])
    key = jax.random.fold_in(KEY, 9)
    want = np.asarray(apply(tree, jnp.array(48), key)[0])
    with torch.no_grad():
        got = run.model(48, noise=torch.from_numpy(j_noise(key)))[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    lines.clear()
    again = tss.train_songsplat(iterations=5, tiny=True, out=out, log_every=1, resume=True,
                                device="cpu", log=lines.append)
    assert lines[1] == "resumed from step 2" and len(again.step_losses) == 2
    assert again.eval["trained_steps"] == 4
    lines.clear()
    rendered = tss.train_songsplat(tiny=True, out=out, render_only=True, device="cpu",
                                   log=lines.append)
    assert rendered.step_losses == [] and rendered.eval["iterations"] == 0
    with pytest.raises(SystemExit):
        tss.train_songsplat(tiny=True, out=str(tmp_path / "empty"), render_only=True,
                            device="cpu", log=lines.append)
