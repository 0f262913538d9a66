"""The port's flagship quality run (``mptpu_torch.models.siam_quality``)
against ``scripts/siam_quality.py`` on JAX-CPU at ``--tiny``'s size (2^13
samples, 4 events, hidden 32, context 16, STFT 512/256, batch 2): the
loss of one step, the script's ``loss_fn`` restated from its lines
(:func:`j_loss_fn`, since it lives inside ``main``), with the fade, the
waveform weight and the gain refit on and off, in float64; then the run's
``metrics.json``, its resume, the ``on_artifacts`` rule of the overfit
trainer (``--commit-artifacts`` without ``git``), the paths the run writes
and a CPU rehearsal of ``chip_smoke.py``'s phase 14 at tiny widths.

The port's parameters are seeded and handed to ``mptpu`` by
``convert.module_to_flax``; ``mptpu``'s noise (event ``i`` draws
``uniform(fold_in(PRNGKey(42), i), (2, 1, 8192))``, drawn under
``jax.enable_x64`` as the jitted loss draws it) is fed to the port.

Tolerances: the float64 loss within rtol 1e-7 and each leaf's gradient
within 1e-5 of its largest. ``mptpu``'s float64 is not float64 throughout
(measured: 2.3e-6 of a leaf's largest at most, the loss 4.4e-9; the FFT
resonance casts to complex64, as ``test_torch_gen_zoo.py`` notes of
``to_complex``).
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from mptpu.losses import iterative_loss as j_iterative_loss
from mptpu.models import siam as js
from mptpu.sparse import quantize as jq
from mptpu_torch import convert
from mptpu_torch.data import synthetic_audio
from mptpu_torch.models import siam_overfit as so
from mptpu_torch.models import siam_quality as sq
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.utils.profile import device_peaks

N, E, HALF, B = 2**13, 4, 2**12, 2
KEY = jax.random.PRNGKey(42)
# the tiny model under flags whose gradients reach every head (sw6's floor and leak)
FLAGS = dict(attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0)
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=E,
           transform_window_size=512, transform_step_size=256, fft_resonance=True,
           residual_clamp_scale=4.0, encoder_clamp=1e4, **FLAGS)
LOSSES = {
    # (waveform weight, gain refit, gain_reg, fade)
    "magnitude": (0.0, 0.0, 0.0, True),
    "wave_refit_reg": (2000.0, 1e-3, 10.0, True),
    "wave_no_fade": (100.0, 0.0, 0.0, False),   # shares the first one's compile
}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module", autouse=True)
def knobs():
    """The selection leak and floor (0.02) in both packages, restored
    afterwards."""
    saved = [(m, m.RELU_SELECTION_LEAK, m.RELU_SELECTION_FLOOR) for m in (jq, tq)]
    for m in (jq, tq):
        m.set_selection_leak(0.02)
        m.set_selection_floor(0.02)
    yield
    for m, leak, floor in saved:
        m.set_selection_leak(leak)
        m.set_selection_floor(floor)


@functools.lru_cache(maxsize=None)
def j_value_and_grad(gain_refit):
    """scripts/siam_quality.py:330-370's loss_fn with its refit flag
    bound, jitted with its gradient. The waveform weight and gain_reg are
    arguments, so that one compile serves several of them: where the
    script skips the waveform term (a weight of 0) it is added here times
    0, which gives the same value and gradient."""
    iterative = js.make_iterative_fn(js.SIAMModel(**CFG))

    def loss_fn(params, target, key, fade, wave_w, gain_reg):
        channels, _, _, _ = iterative(params, target, key)
        loss = j_iterative_loss(target * fade, channels,
                                lambda x: js.siam_transform(x, 512, 256, mag_epsilon=1e-6))
        recon = jnp.sum(channels, axis=1, keepdims=True)
        if gain_refit:
            gains = jnp.clip(js.refit_event_gains(target, channels, ridge=gain_refit, span=HALF),
                             -10.0, 10.0)
            recon = jnp.einsum("be,ben->bn", gains, channels)[:, None]
            alive = jnp.sum(channels[..., :HALF] ** 2, axis=-1) > 1e-12
            loss = loss + gain_reg * jnp.sum(
                jnp.where(alive, (gains - 1.0) ** 2, 0.0)) / jnp.maximum(jnp.sum(alive), 1)
        wave = jnp.sum((recon[..., :HALF] - target[..., :HALF]) ** 2) / jnp.maximum(
            jnp.sum(target[..., :HALF] ** 2), 1e-12)
        return loss + wave_w * wave

    return jax.jit(jax.value_and_grad(loss_fn))


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", list(LOSSES))
def test_step_loss_and_gradients_in_float64(variant):
    wave_w, gain_refit, gain_reg, fade_on = LOSSES[variant]
    target = np.stack([synthetic_audio(N, seed=s, sustained=True)[None] for s in (5, 6)])
    target = target.astype(np.float64)
    fade = np.asarray(js.fade_tail(N), np.float64) if fade_on else np.ones((1, 1, N))
    tm = sq.quality_model(tiny=True, device="cpu", **FLAGS)[0].double()
    params = convert.module_to_flax(tm)
    with jax.enable_x64(True):
        noise = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(KEY, i), (B, 1, N),
                                                        minval=-1.0, maxval=1.0))
                          for i in range(E)])
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jl, jg = j_value_and_grad(gain_refit)(p64, jnp.asarray(target), KEY, jnp.asarray(fade),
                                              jnp.float64(wave_w), jnp.float64(gain_reg))
        jl, jg = float(jl), leaves(jg)
    t, f = torch.from_numpy(target), torch.from_numpy(fade)
    loss, _ = sq.siam_quality_loss(tm, so.LossSettings(512, 256, gain_refit, gain_reg),
                                   torch.from_numpy(noise), wave_w, t * f, t,
                                   torch.sum(t[..., :HALF] ** 2))
    params_t = list(tm.parameters())
    grads = torch.autograd.grad(loss, params_t, allow_unused=True)
    with so.parameters_swapped(tm, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(params_t, grads)]):
        tg = leaves(convert.module_to_flax(tm))
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-7)
    assert set(tg) == set(jg)
    for k, w in jg.items():
        assert np.abs(tg[k] - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), k


def small_run(out, **kw):
    args = dict(tiny=True, iterations=7, timing_steps=1, eval_every=3, stream_eval_every=6,
                waveform_weight=100.0, gain_refit=1e-3, fixed_noise=True, device="cpu",
                log=lambda s: None, **FLAGS)
    args.update(kw)
    return sq.run_siam_quality(str(out), **args)


def batches(k):
    return [np.stack([synthetic_audio(N, seed=50 + 2 * i + j, sustained=True)[None]
                      for j in range(B)]) for i in range(k)]


def test_metrics_json_and_resume(tmp_path):
    """metrics.json holds the keys scripts/report.py reads and the evals;
    a resume from the run's last checkpoint restores its parameters and
    Adam's state bit for bit, and its next step's loss is the
    uninterrupted run's."""
    data = batches(8)
    a = small_run(tmp_path, stream=data[:7])
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert {"config", "init_s", "first_step_s", "ms_per_step_synced", "ms_per_step_pipelined",
            "eval", "losses"} <= set(metrics)
    (entry,) = metrics["eval"]
    assert entry["step"] == 6 and {"holdout_snr_db", "holdout_lsd_db", "recon_rms",
                                   "streaming_pristine_lsd_db"} <= set(entry)
    assert metrics["config"].startswith("n_samples 2^13, 4 events, batch 2, STFT 512/256, ")
    assert "waveform_weight 100, " in metrics["config"] and "gain_refit 0.001" in metrics["config"]
    assert [i for i, _ in a.step_losses] == [0, 1, 100, 300, 4, 5, 6]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000006.pkl", "metrics.json"]
    b = small_run(tmp_path, stream=data[7:], resume=True, iterations=8)
    step, params, opt = b.resumed
    assert step == 6
    want_params, want_opt = a.run.trainer.snapshot()
    assert all(torch.equal(x, y) for x, y in zip(params, want_params))
    assert all(torch.equal(x, y) for x, y in zip((opt.count, *opt.mu, *opt.nu),
                                                 (want_opt.count, *want_opt.mu, *want_opt.nu)))
    loss = float(a.run.step(7, torch.from_numpy(data[7])))
    assert b.step_losses == [(7, loss)]
    resumed = json.loads((tmp_path / "metrics.json").read_text())
    assert resumed["ms_per_step_synced"] == metrics["ms_per_step_synced"]
    assert resumed["eval"] == metrics["eval"]


def test_run_writes_only_into_out_and_the_cache(tmp_path, monkeypatch):
    """From a working directory of its own the run writes its
    checkpoints and metrics into ``out``; the dense corpora go under the
    cache directory, never under ``trained_weights``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    small_run("out", iterations=3, timing_steps=0, eval_every=100, fresh_corpus=True)
    assert sorted(os.listdir(tmp_path)) == ["cache", "out"]
    assert {"dense_corpus", "dense_corpus_holdout"} <= set(os.listdir(tmp_path / "cache"))
    assert sorted(os.listdir(tmp_path / "out")) == ["ckpt_000000002.pkl", "metrics.json"]
    assert "corpus fresh-infinite" in json.loads((tmp_path / "out" / "metrics.json")
                                                 .read_text())["config"]


def test_artifact_rule_with_a_fake_clock(tmp_path):
    """metrics.json (and storm.log once it exists) at every call; the best
    checkpoints at most once in 900 s unless forced; a failing callback
    is logged, not raised."""
    now = [1000.0]
    calls, logged = [], []
    sink = so.ArtifactSink(str(tmp_path), calls.append, clock=lambda: now[0], log=logged.append)
    ema = str(tmp_path / "ema_best.pkl")
    open(ema, "wb").close()
    m = str(tmp_path / "metrics.json")
    sink()
    sink([ema])
    now[0] += 100
    sink([ema])
    (tmp_path / "storm.log").write_text("x")
    sink([ema, str(tmp_path / "missing.pkl")], force=True)
    now[0] += 899
    sink([ema])
    now[0] += 2
    sink([ema])
    assert calls == [[m], [m, ema], [m], [m, str(tmp_path / "storm.log"), ema],
                     [m, str(tmp_path / "storm.log")], [m, str(tmp_path / "storm.log"), ema]]

    def broken(paths):
        raise OSError("disk full")

    so.ArtifactSink(str(tmp_path), broken, log=logged.append)()
    assert logged and "disk full" in logged[0]
    so.ArtifactSink(str(tmp_path), None)()   # no callback: nothing to do


def test_overfit_hands_its_artifacts_to_the_callback(tmp_path):
    """overfit_siam (sw6's flags, the EMA on) with ``on_artifacts``: the
    first eval's new best EMA checkpoint goes with metrics.json, the later
    metrics writes within 900 s carry metrics.json alone, and the end
    hands both best checkpoints, forced."""
    calls = []
    so.overfit_siam(iterations=4, eval_every=2, tiny=True, walk_eval_every=2, out=str(tmp_path),
                    device="cpu", log=lambda s: None, on_artifacts=calls.append,
                    **dict(so.SW6, stream_windows=1, audio_events=4))
    m, ema, walk = (str(tmp_path / f) for f in ("metrics.json", "ema_best.pkl", "walk_best.pkl"))
    assert calls[0] == [m, ema]
    assert calls[1:-1] and all(c == [m] for c in calls[1:-1])
    assert calls[-1] == [m, ema, walk]


def test_chip_phase_rehearsal():
    """chip_smoke.py's phase 14 on the CPU at tiny widths, its CPU side in
    a process of its own: every part runs, every gate holds, no launch."""
    records = {"cuda_fused_step_pipelined": {}}
    chip_smoke.entry_points_phase(torch.device("cpu"), chip_smoke.ENTRY_SMALL,
                                  device_peaks("H100"), lambda: None, records)
    assert records["cuda_fused_step_pipelined"] == {"launches_mp_train": 0,
                                                    "launches_mp_train_multiband": 0}
