"""The SIAM overfit loop: ``mptpu``'s own ``scripts/siam_overfit.py`` main()
on JAX-CPU against the port's ``overfit_siam``, at ``--tiny``'s size under
sw6's flags, for 9 iterations from one ``--init-from`` file (the port's
seeded parameters as ``mptpu``'s flax variables) with ``mptpu``'s fixed
noise fed to the port: evals at steps 4 and 8 over two half-overlapped
windows with the window balance, the EMA, the gain refit and the alignment
refinement, and one walk eval. Also the port's ``--resume`` and its
flag-drift warning.

The loop runs at lr 3e-5, a tenth of sw6's. Adam divides each entry by its
own gradient, so an entry whose gradient is near the float32 noise floor
moves by up to the learning rate either way in either package
(``tests/test_torch_siam_train.py`` holds the step itself at sw6's 3e-4);
at 3e-4 the two 8-step trajectories separate where the decode is near
silence: first-half LSD 72.1 dB in the port against 114.9 in ``mptpu`` at
step 4, every SNR equal to 0.001 dB.

Tolerances, each set between what the sound loop reads and what a loop
with a planted fault (steps on window 0 only, no EMA update, or no
parameter update) reads: every step's loss, as ``StormGuard.classify``
receives it, within 1e-3 relative (measured 2.0e-4; the loss of window 0
falls 17% in its first four steps) and its gradient norm within 10%
(measured 2.3%; the windows' norms differ up to a hundredfold); the
parameters' change over the 8 updates (``ckpt_000000008.pkl`` less the
init file) within 0.25 of the norm of ``mptpu``'s change (measured 0.107)
and the saved EMA's change within 0.4 of ``mptpu``'s (measured 0.185); the
logged loss within 1e-4 relative; each eval entry's counts, steps and
flags equal, its SNRs within 0.01 dB, its PIF distances within 1e-3, its
schedule maximum within 1e-4 relative, and its LSDs within 1% (they are
86 to 124 dB here: the decode is near silence in most bins, where 20 log10
of a magnitude near the 1e-8 floor follows float32 rounding; measured
0.6%).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.models import siam as js
from mptpu.sparse import quantize as jq
from mptpu.train import checkpoint as jckpt
from mptpu.utils import platform as jplatform
from mptpu_torch import convert
from mptpu_torch.models import siam as ts
from mptpu_torch.models import siam_overfit as tso
from mptpu_torch.sparse import quantize as tq
from mptpu_torch.train import checkpoint as tckpt

ROOT = Path(__file__).resolve().parents[1]
N, E = 2**13, 4
# sw6's flags (scripts/siam_overfit.py; its metrics.json config) at --tiny, two windows
FLAGS = dict(tso.SW6, lr=3e-5, stream_windows=2, align_refine=64, tiny=True, iterations=9, eval_every=4,
             walk_eval_every=8)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two CPU threads for this module's PyTorch work: the tier-1 run puts
    six test processes on one machine, where PyTorch's default of a thread
    a core makes every process wait on descheduled threads."""
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def argv(flags):
    out = []
    for k, v in flags.items():
        name = "--" + k.replace("_", "-")
        if v is True:
            out.append(name)
        elif v is not False:
            out += [name, str(v)]
    return out


def jax_noise():
    key = jax.random.PRNGKey(42)
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (1, 1, N),
                                                   minval=-1.0, maxval=1.0))
                     for i in range(E)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(mptpu's metrics, the port's result, the run directory, the port's
    log lines, mptpu's (step, loss, gradient norm) of every finite step):
    both trainers from one init file."""
    root = tmp_path_factory.mktemp("siam_loop")
    model = ts.SIAMModel(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32,
                         n_events=E, transform_window_size=512, transform_step_size=256,
                         switch_bias_init=1.0, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    init = root / "init.pkl"
    tckpt.save_checkpoint(str(init), convert.module_to_flax(model), None, 0)
    saved = [(m, m.RELU_SELECTION_LEAK, m.RELU_SELECTION_FLOOR) for m in (jq, tq)]
    kept = jplatform.enable_compilation_cache
    jplatform.enable_compilation_cache = lambda *a, **k: None   # no cache outside the run
    try:
        spec = importlib.util.spec_from_file_location("siam_overfit_script",
                                                      ROOT / "scripts" / "siam_overfit.py")
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)

        class RecordingGuard(script.StormGuard):
            """The script's guard, keeping each step's scalars as read."""

            def classify(self, ci, loss, gnorm, ok):
                seen.append((ci, loss, gnorm))
                return super().classify(ci, loss, gnorm, ok)

        seen = []
        script.StormGuard = RecordingGuard
        old_argv = sys.argv
        sys.argv = ["siam_overfit.py"] + argv(dict(FLAGS, out=str(root / "jax"),
                                                   init_from=str(init)))
        try:
            script.main()
        finally:
            sys.argv = old_argv
            import faulthandler

            faulthandler.cancel_dump_traceback_later()
    finally:
        jplatform.enable_compilation_cache = kept
        for m, leak, floor in saved:
            m.set_selection_leak(leak)
            m.set_selection_floor(floor)
    with open(root / "jax" / "metrics.json") as f:
        jmetrics = json.load(f)
    lines = []
    result = tso.overfit_siam(**FLAGS, out=str(root / "port"), init_from=str(init),
                              noise=torch.from_numpy(jax_noise()), device="cpu",
                              log=lines.append)
    return jmetrics, result, root, lines, seen


def assert_entry_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith("snr_db") and isinstance(w, list):
            np.testing.assert_allclose(g, w, atol=0.01, err_msg=k)
        elif k.endswith("snr_db"):
            assert abs(g - w) <= 0.01 + 1e-3, (k, g, w)
        elif k.endswith("lsd_db"):
            assert abs(g - w) <= 0.01 * abs(w), (k, g, w)
        elif k.endswith("pif_dist"):
            assert abs(g - w) <= 1e-3 + 1e-4, (k, g, w)
        elif k == "sched_max":
            assert abs(g - w) <= 1e-4 * abs(w) + 1e-4, (k, g, w)
        else:
            assert g == w, (k, g, w)


def test_loop_metrics_against_the_script(runs):
    """Every step's loss and gradient norm against the script's, and
    metrics.json of both runs: the config line identical, the losses,
    both evals, the walk eval and the summary fields within the module's
    tolerances; the port read each step's scalars one step late (8 of 9)
    and every step was finite."""
    jm, result, _, _, seen = runs
    assert [s[0] for s in seen] == [s[0] for s in result.steps] == list(range(8))
    for (_, lj, gj), (_, lp, _, gp, _) in zip(seen, result.steps):
        assert abs(lp - lj) <= 1e-3 * abs(lj), (lp, lj)
        assert abs(gp - gj) <= 0.1 * abs(gj), (gp, gj)
    # the training moved the loss far past its tolerance: window 0's steps
    assert seen[4][1] < (1 - 0.1) * seen[0][1]
    pm = result.metrics
    assert pm["config"] == jm["config"]
    assert [s for s, _ in pm["losses"]] == [s for s, _ in jm["losses"]] == [0]
    for (_, lp), (_, lj) in zip(pm["losses"], jm["losses"]):
        assert abs(lp - lj) <= 1e-4 * abs(lj) + 0.01
    assert [e["step"] for e in pm["eval"]] == [e["step"] for e in jm["eval"]] == [4, 8]
    for got, want in zip(pm["eval"], jm["eval"]):
        assert_entry_close(got, want)
    assert len(pm["walk"]) == len(jm["walk"]) == 1
    assert_entry_close(pm["walk"][0], jm["walk"][0])
    for k in ("best_first_half_snr_db", "best_artifact_mean_window_snr_db",
              "best_walk_refit_full_snr_db", "best_aligned_first_half_snr_db"):
        assert abs(pm[k] - jm[k]) <= 0.011, k
    assert pm["artifact_selection"] == jm["artifact_selection"]
    assert [s[0] for s in result.steps] == list(range(8))
    assert all(s[4] for s in result.steps)


def test_the_ports_checkpoints_load_in_mptpu(runs):
    """The port's ema_best.pkl, walk_best.pkl and last numbered checkpoint
    load in mptpu's load_checkpoint as the same tree as mptpu's own (names,
    shapes), each moved from the init file as mptpu's moved (the norm of
    the difference of the two changes over the norm of mptpu's: 0.4 for
    the EMA, 0.25 for the parameters), and the EMA decodes in mptpu's
    model; the port's numbered checkpoint carries its optimiser state in
    its own layout, which --resume reads."""
    _, result, root, _, _ = runs
    start = dict(jax.tree_util.tree_leaves_with_path(
        jckpt.load_checkpoint(str(root / "init.pkl"))["params"]))
    for name, tol in (("ema_best.pkl", 0.4), ("walk_best.pkl", 0.4), ("ckpt_000000008.pkl", 0.25)):
        got = jckpt.load_checkpoint(str(root / "port" / name))
        want = jckpt.load_checkpoint(str(root / "jax" / name))
        assert got["step"] == want["step"] == 8
        gl = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
        wl = dict(jax.tree_util.tree_leaves_with_path(want["params"]))
        assert set(gl) == set(wl) == set(start)
        for k, w in wl.items():
            assert gl[k].shape == w.shape and gl[k].dtype == np.float32
        moved = [(np.asarray(gl[k], np.float64) - start[k], np.asarray(wl[k], np.float64) - start[k])
                 for k in sorted(start, key=jax.tree_util.keystr)]
        miss = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in moved))
        want_moved = np.sqrt(sum(np.sum(w ** 2) for _, w in moved))
        assert want_moved > 0 and miss <= tol * want_moved, (name, miss, want_moved)
    last = tckpt.load_checkpoint(str(root / "port" / "ckpt_000000008.pkl"))
    assert last["step"] == 8 and last["opt_state"]["count"] == 9
    names = [n for n, _ in result.trainer.model.named_parameters()]
    assert list(last["opt_state"]["mu"]) == names
    # the EMA it saved decodes in mptpu's model, jitted
    jm = js.SIAMModel(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32,
                      n_events=E, transform_window_size=512, transform_step_size=256,
                      fft_resonance=True, attn_floor=0.01, attn_leak=0.1, switch_bias_init=1.0,
                      switch_clamp=20.0, residual_clamp_scale=4.0, encoder_clamp=1e4,
                      vec_clamp=10.0)
    ema = jckpt.load_checkpoint(str(root / "port" / "ema_best.pkl"))["params"]
    audio = jnp.zeros((1, 1, N)).at[..., : N // 2].set(1e-2)
    out = jax.jit(js.make_iterative_fn(jm))(ema, audio, jax.random.PRNGKey(42))
    assert np.isfinite(np.asarray(out[0])).all()


def test_resume_continues_and_skips_vec_clamp_drift(runs, tmp_path):
    """--resume restarts after the newest checkpoint with its parameters
    and optimiser state, keeping the metrics. Its flag-drift warning names
    a dropped spectral_skip (and siam_from_flax skips the stale layer), but,
    as mptpu's (scripts/siam_overfit.py:623, ROADMAP C), not a dropped
    vec_clamp."""
    _, result, root, _, _ = runs
    out = tmp_path / "resumed"
    out.mkdir()
    for name in ("ckpt_000000008.pkl", "metrics.json"):
        (out / name).write_bytes((root / "port" / name).read_bytes())
    lines = []
    flags = dict(FLAGS, iterations=10, vec_clamp=0.0)
    resumed = tso.overfit_siam(**flags, out=str(out), resume=True, device="cpu",
                               noise=torch.from_numpy(jax_noise()), log=lines.append)
    assert "resumed from step 8" in lines
    assert not any("WARNING" in ln for ln in lines)
    assert resumed.last_step == 9 and len(resumed.metrics["eval"]) == 2
    assert int(resumed.trainer.opt_state.count) == 10
    skip = tmp_path / "skip"
    tso.overfit_siam(**dict(FLAGS, iterations=3, walk_eval_every=0), spectral_skip=True,
                     out=str(skip), device="cpu", noise=torch.from_numpy(jax_noise()),
                     log=lambda line: None)
    lines.clear()
    with pytest.warns(UserWarning, match="spec_skip_proj"):
        tso.overfit_siam(**dict(FLAGS, iterations=4, walk_eval_every=0), out=str(skip),
                         resume=True, device="cpu", noise=torch.from_numpy(jax_noise()),
                         log=lines.append)
    warned = [ln for ln in lines if ln.startswith("WARNING")]
    assert len(warned) == 1 and "spectral_skip=False" in warned[0]


def test_grad_anatomy_names_every_leaf_as_mptpu_does(tmp_path):
    """--grad-anatomy-from: from that step on, one JSON line a step with
    every parameter's gradient norm under mptpu's key path (the
    jax.tree_util.keystr of its flax leaf), each finite."""
    out = tmp_path / "anatomy"
    tso.overfit_siam(**dict(FLAGS, iterations=3, walk_eval_every=0), grad_anatomy_from=1,
                     out=str(out), device="cpu", noise=torch.from_numpy(jax_noise()),
                     log=lambda line: None)
    lines = [json.loads(ln) for ln in (out / "grad_anatomy.jsonl").read_text().splitlines()]
    assert [ln["iter"] for ln in lines] == [1, 2]
    model = ts.SIAMModel(n_samples=N, context_dim=16, in_channels=257, hidden_channels=32,
                         n_events=E, transform_window_size=512, transform_step_size=256,
                         device="cpu")
    want = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(convert.module_to_flax(model))}
    for ln in lines:
        assert set(ln["leaf_gnorms"]) == want
        assert all(np.isfinite(v) for v in ln["leaf_gnorms"].values())
