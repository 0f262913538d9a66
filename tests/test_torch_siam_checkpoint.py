"""The trained SIAM checkpoints committed under ``trained_weights/``, at
their full width on the CPU, through the port and through ``mptpu`` on
JAX-CPU with ``mptpu``'s noise (``fold_in(PRNGKey(42), i)`` for event
``i``, the ``--fixed-noise`` training draw):

- ``siam_overfit_full_sw6/ema_best.pkl`` (2^17 samples, 32 events, hidden
  128, 6.59 M parameters): ``scripts/codec_rate.py``'s first window
  (``:237-320``): the encode, the f16 wire decode and the shift and gain
  refinement within 256 samples, built with the script's flags;
- ``medium_gainreg/ema_best.pkl`` (2^15 samples, 16 events, hidden 64):
  the default ``handoff`` walk over two windows, with the fixed noise.

Event frames identical; channels within 1e-4 of their largest; SNR within
0.01 dB. sw6's tree holds a ``spec_skip_proj`` layer (32,832 of its
6,593,601 parameters) that its recorded config turns off (``spectral_skip
False``); the model is built from the config, as ``codec_rate.py:185-196``
builds it, and the layer is skipped.
"""

import warnings
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.models import siam as js
from mptpu.sparse import quantize as jq
from mptpu.train.checkpoint import load_checkpoint as j_load
from mptpu_torch import convert
from mptpu_torch.data import synthetic_audio
from mptpu_torch.models import inference as tinf
from mptpu_torch.models import siam as ts
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "trained_weights"
KEY = jax.random.PRNGKey(42)
SR = 22050
# scripts/codec_rate.py:187-196 with its defaults and the recorded STFT 2048/256
FLAGS = dict(samplerate=SR, context_dim=32, in_channels=1025, transform_window_size=2048,
             transform_step_size=256, fft_resonance=True, attn_floor=0.01, attn_leak=0.1,
             switch_clamp=20.0, residual_clamp_scale=4.0, encoder_clamp=1e4)


@pytest.fixture
def knobs():
    """codec_rate.py's selection leak and floor (0.02), restored after."""
    saved = [(m, m.RELU_SELECTION_LEAK, m.RELU_SELECTION_FLOOR) for m in (jq, tq)]
    for m in (jq, tq):
        m.set_selection_leak(0.02)
        m.set_selection_floor(0.02)
    yield
    for m, leak, floor in saved:
        m.set_selection_leak(leak)
        m.set_selection_floor(floor)


def jax_noise(n_events, size=8192):
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(KEY, i), (1, 1, size),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(n_events)])


def snr(target, recon):
    target, recon = np.asarray(target, np.float64), np.asarray(recon, np.float64)
    return 10 * np.log10(max(np.sum(target**2), 1e-12) / max(np.sum((target - recon) ** 2),
                                                              1e-12))


def port_model(path, **cfg):
    payload = load_checkpoint(str(path))
    assert payload is not None, path
    model = ts.SIAMModel(**FLAGS, **cfg, device="cpu")
    if "spec_skip_proj" in payload["params"]["params"]:
        with pytest.warns(UserWarning, match="spec_skip_proj"):
            convert.siam_from_flax(model, payload["params"])
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            convert.siam_from_flax(model, payload["params"])
    return model


def j_quantize(vecs, schedules):
    """scripts/codec_rate.py:53-76, the f16 preset."""
    idx = jnp.argmax(schedules, axis=-1)
    amp = jnp.take_along_axis(schedules, idx[..., None], axis=-1)
    amp16 = amp.astype(jnp.float16).astype(jnp.float32)
    sched_q = jax.nn.one_hot(idx, schedules.shape[-1], dtype=jnp.float32) * amp16
    return vecs.astype(jnp.float16).astype(jnp.float32), sched_q


def test_sw6_first_window_matches_mptpu(knobs):
    """codec_rate.py's first window of sw6's segment (seed 3, 24 events
    over 262,144 samples, fade-tailed): raw, f16-wire and refined
    first-half SNR within 0.01 dB of mptpu's, frames and shifts identical,
    the wire quantization identical."""
    n, half = 2**17, 2**16
    path = WEIGHTS / "siam_overfit_full_sw6" / "ema_best.pkl"
    cfg = dict(n_samples=n, hidden_channels=128, n_events=32)
    model = port_model(path, **cfg)
    assert sum(p.numel() for p in model.parameters()) == 6_560_769
    seg = synthetic_audio(262144, SR, n_events=24, seed=3, sustained=True)
    target = seg.reshape(1, 1, -1)[..., :n]
    enc_input = target * np.asarray(js.fade_tail(n))
    noise = jax_noise(32)

    # mptpu, as codec_rate.py runs it
    jm = js.SIAMModel(**FLAGS, **cfg)
    params = jax.tree_util.tree_map(jnp.asarray, j_load(str(path))["params"])
    channels, vecs, schedules, _ = jax.jit(js.make_iterative_fn(jm))(
        params, jnp.asarray(enc_input), KEY)
    vecs_q, sched_q = j_quantize(vecs, schedules)
    generate = jax.jit(lambda p, v, s, k: jm.apply(p, v, s, k, method=js.SIAMModel.generate))
    ch_q = jnp.concatenate([generate(params, vecs_q[:, i: i + 1], sched_q[:, i: i + 1],
                                     jax.random.fold_in(KEY, i)) for i in range(32)], axis=1)
    _, shifts, gains = js.refine_event_alignment(jnp.asarray(target[..., :half]),
                                                 ch_q[..., :half], max_shift=256)
    idx = (jnp.arange(n)[None, None, :] - shifts[..., None].astype(jnp.int32)) % n
    recon_ref = jnp.einsum("be,ben->bn", gains.astype(jnp.float16).astype(jnp.float32),
                           jnp.take_along_axis(ch_q, idx, axis=-1))[:, None]
    want = dict(raw=snr(target[..., :half], jnp.sum(channels, 1, keepdims=True)[..., :half]),
                wire=snr(target[..., :half], jnp.sum(ch_q, 1, keepdims=True)[..., :half]),
                refined=snr(target[..., :half], recon_ref[..., :half]))

    # the port, through its codec
    codec = tinf.SIAMCodec(model=model, checkpoint_dir=None, noise=torch.from_numpy(noise))
    enc = codec.encode(torch.from_numpy(enc_input))
    tv_q, ts_q, wire_bytes = tinf.quantize_events(enc.vecs, enc.schedules, "f16")
    tch_q = codec.render(tv_q, ts_q)
    with torch.no_grad():
        _, tshifts, tgains = ts.refine_event_alignment(torch.from_numpy(target[..., :half]),
                                                       tch_q[..., :half], max_shift=256)
    trecon_ref = codec.decode(tinf.SIAMEncoding(tv_q, ts_q, tch_q, tgains.half().float(),
                                                tshifts))
    got = dict(raw=snr(target[..., :half], enc.channels.sum(1, keepdim=True)[..., :half]),
               wire=snr(target[..., :half], tch_q.sum(1, keepdim=True)[..., :half]),
               refined=snr(target[..., :half], trecon_ref[..., :half]))

    np.testing.assert_array_equal(enc.schedules.argmax(-1).numpy(),
                                  np.asarray(schedules).argmax(-1))
    assert wire_bytes == 2 * 32 + 4
    np.testing.assert_array_equal(tv_q.numpy(), np.asarray(vecs_q))
    np.testing.assert_array_equal(ts_q.numpy(), np.asarray(sched_q))
    np.testing.assert_array_equal(tshifts.numpy(), np.asarray(shifts))
    for ours, theirs in ((enc.channels, channels), (tch_q, ch_q)):
        assert np.abs(ours.numpy() - np.asarray(theirs)).max() <= 1e-4 * np.abs(theirs).max()
    print("sw6 first-half SNR, dB (port, mptpu): " + ", ".join(
        f"{k} {got[k]:.4f} {want[k]:.4f}" for k in want))
    for k in want:
        assert abs(got[k] - want[k]) < 0.01, (k, got[k], want[k])


def test_medium_handoff_walk_matches_mptpu(knobs):
    """medium_gainreg through the default handoff walk over two windows of
    a seed-3 segment of 2^16 samples, every window with the fixed training
    noise; frames identical, the decode within 1e-4 of its largest and its
    SNR within 0.01 dB of mptpu's."""
    n = 2**15
    path = WEIGHTS / "medium_gainreg" / "ema_best.pkl"
    cfg = dict(n_samples=n, hidden_channels=64, n_events=16)
    model = port_model(path, **cfg)
    audio = synthetic_audio(2 * n, SR, n_events=24, seed=3, sustained=True).reshape(1, 1, -1)
    jm = js.SIAMModel(**FLAGS, **cfg)
    params = jax.tree_util.tree_map(jnp.asarray, j_load(str(path))["params"])
    want = js.streaming_encode(jm, params, jnp.asarray(audio), KEY, return_event_vectors=True,
                               fixed_noise=True)
    got = ts.streaming_encode(model, torch.from_numpy(audio), torch.from_numpy(jax_noise(16)),
                              return_event_vectors=True, fixed_noise=True)
    assert got[2].shape[1] == 2 * 16
    np.testing.assert_array_equal(got[2].argmax(-1).numpy(), np.asarray(want[2]).argmax(-1))
    final, jfinal = got[0].numpy(), np.asarray(want[0])
    assert np.abs(final - jfinal).max() <= 1e-4 * np.abs(jfinal).max()
    print(f"medium_gainreg handoff walk SNR, dB (port, mptpu): {snr(audio, final):.4f} "
          f"{snr(audio, jfinal):.4f}")
    assert abs(snr(audio, final) - snr(audio, jfinal)) < 0.01
