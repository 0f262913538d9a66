"""The port's rate report (``mptpu_torch.models.codec_rate.rate_report``)
against ``scripts/codec_rate.py`` run on JAX-CPU, on one run directory: a
seeded tiny SIAM checkpoint (the port's parameters at
``scripts/siam_overfit.py --tiny``'s size, 2^13 samples, 4 events, hidden
32, context 16, STFT 512/256) written by ``mptpu``'s ``save_checkpoint`` as
``ema_best.pkl``, beside a ``metrics.json`` whose config line records a
two-window segment. The script runs as a subprocess with ``--run`` there
(it writes its report and WAVs into ``--run``), the flags small and the
walk on; the port gets ``mptpu``'s noise (event ``i`` draws from
``fold_in(PRNGKey(42), i)``) and writes into a directory of its own.

Tolerances: counts, bytes, kbps and entropy bits equal to the written
digit; every SNR within 0.01 dB (the script writes three decimals); each
PIF distance within rtol 1e-4 beyond the half unit of the fourth decimal
that the script keeps. An LSD is held within 0.01 dB plus twice the
metric's own float32 resolution on this decode, measured by
``chip_smoke.lsd_resolution``: the untrained model's decode leaves most STFT bins at
the level of float32 rounding, where ``20 log10(|X| + 1e-8)`` moves by
decibels, so the float32 LSD of one decode stands 0.05 dB from its
float64 value while the two packages' float32 LSDs are 0.013 dB apart.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from mptpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mptpu_torch import convert
from mptpu_torch.models import codec_rate as cr
from mptpu_torch.models import siam as ts

ROOT = Path(__file__).resolve().parent.parent
N, E = 2**13, 4
CFG = dict(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32, n_events=E,
           transform_window_size=512, transform_step_size=256, fft_resonance=True,
           attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0, switch_clamp=20.0,
           residual_clamp_scale=4.0, encoder_clamp=1e4)
CONFIG = ("overfit 1 segment seed 3, n_samples 2^13, 4 events, STFT 512/256, lr 0.0003, "
          "audio_events 4, stream_windows 2, spectral_skip False, spectral_filter False")
FLAGS = dict(n_samples_log2=13, n_events=E, hidden=32, context_dim=16, refine=64)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def jax_noise(key=jax.random.PRNGKey(42), n_events=E, size=N):
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (1, 1, size),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(n_events)])


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """(the script's codec_rate.json, the port's report unrounded, the
    port's written JSON, the run directory, the port's output directory)."""
    run = tmp_path_factory.mktemp("run")
    model = ts.SIAMModel(**CFG, generator=torch.Generator().manual_seed(1), device="cpu")
    j_save_checkpoint(str(run / "ema_best.pkl"), convert.module_to_flax(model), None, 7)
    (run / "metrics.json").write_text(json.dumps({"config": CONFIG, "eval": []}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, str(ROOT / "scripts" / "codec_rate.py"), "--run", str(run), "--walk",
           "--watchdog-s", "600"] + [f"--{k.replace('_', '-')}={v}" for k, v in FLAGS.items()]
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    want = json.loads((run / "codec_rate.json").read_text())
    run_files = sorted(os.listdir(run))
    out = tmp_path_factory.mktemp("port_out")
    lines = []
    got = cr.rate_report(str(run), str(out), walk=True, noise=torch.from_numpy(jax_noise()),
                         device="cpu", log=lines.append, **FLAGS)
    assert sorted(os.listdir(run)) == run_files   # the port leaves the run as it was
    written = json.loads((out / "codec_rate.json").read_text())
    assert any("[config] --stream-windows <- 2" in ln for ln in lines)
    return want, got, written, run, out


def walk_pairs(want, got, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            yield from walk_pairs(w, got[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", k, w, got[k]


def keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out |= keys(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k}
    return out


def test_report_has_the_scripts_keys(reports):
    want, got, written, _, _ = reports
    assert keys(written) == keys(got) == keys(want)
    assert want["walk"]["n_windows"] == got["walk"]["n_windows"] >= 2


def lsd_resolution(out):
    """|float32 - float64| of the port's LSD between the walk's target and
    the port's refined f16 walk decode (its WAV in ``out``)."""
    seg = torch.from_numpy(cr.segment(N, audio_events=4, stream_windows=2)).reshape(1, 1, -1)
    return chip_smoke.lsd_resolution(cr.walk_target(seg, N), out / "recon_wire_walk_f16.wav",
                                     512, 256)


@pytest.mark.parametrize("kind", ["counts", "decibels", "pif"])
def test_report_matches_the_scripts(reports, kind):
    want, got, written, _, out = reports
    lsd_tol = 0.01 + 2 * lsd_resolution(out)
    checked = 0
    for path, key, w, g in walk_pairs(want, got):
        if isinstance(w, str):
            assert key == "ckpt" and g == w
        elif kind == "counts" and not (key.endswith("_db") or key.endswith("pif_dist")):
            assert written_value(written, path) == w, path
            checked += 1
        elif kind == "decibels" and key.endswith("_db"):
            assert abs(g - w) <= (lsd_tol if "lsd" in key else 0.01), (path, g, w)
            checked += 1
        elif kind == "pif" and key.endswith("pif_dist"):
            assert abs(g - w) <= 1e-4 * abs(w) + 5e-5, (path, g, w)
            checked += 1
    assert checked >= {"counts": 20, "decibels": 12, "pif": 4}[kind]


def written_value(written, path):
    node = written
    for k in path.split("."):
        node = node[k]
    return node


def test_port_writes_its_report_and_wavs_into_out(reports):
    """The port's files go into ``out`` (the fixture checks that the run
    directory is left as the script left it)."""
    _, _, _, _, out = reports
    assert sorted(os.listdir(out)) == ["codec_rate.json", "recon_wire_f16.wav",
                                       "recon_wire_walk_f16.wav"]


def test_checkpoint_choice(tmp_path):
    """``ckpt`` when given, else ``ema_best.pkl``, else the last
    ``ckpt_*.pkl``; none raises."""
    with pytest.raises(FileNotFoundError):
        cr.choose_checkpoint(str(tmp_path))
    for name in ("ckpt_000000010.pkl", "ckpt_000000002.pkl"):
        (tmp_path / name).write_bytes(b"")
    assert cr.choose_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_000000010.pkl")
    (tmp_path / "ema_best.pkl").write_bytes(b"")
    assert cr.choose_checkpoint(str(tmp_path)) == str(tmp_path / "ema_best.pkl")
    assert cr.choose_checkpoint(str(tmp_path), "x.pkl") == "x.pkl"
