"""The dated-experiment runner of the port (``mptpu_torch.models.experiment``)
and its template (``experiment_template``) against ``scripts/experiment.py``
and the template it scaffolds (``experiments/e_2026_8_16/experiment.py``),
on JAX-CPU, each loaded with ``importlib``; the repository's
``experiments/`` is never written.

The template's fit runs at 2^13 samples (a subclass sets ``n_samples``),
both packages on one seeded target (their ``AudioIterator`` patched to it),
the port carrying ``mptpu``'s initial parameters (``model.init(PRNGKey(0),
PRNGKey(0))``, by ``convert.splat_from_flax``) and its per-step noise
(``uniform(fold_in(PRNGKey(0), i), (1, 1, n))``). Tolerances: the first
loss within rtol 1e-4 beyond the half unit of the fourth decimal the
template prints; after one Adam step, the loss at each package's
parameters on the next step's noise within rtol 1e-3 (after three steps
the two stand 0.2% apart: Adam moves an entry whose float32 gradient is
noise a whole step either way, so trajectories are compared from shared
states).
"""

import contextlib
import importlib.util
import io
import os
import re
from datetime import datetime
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mptpu.losses import iterative_loss as j_iterative_loss
from mptpu.models import OverfitHierarchicalEvents as JModel
from mptpu.models import splat_loss_transform as j_transform
from mptpu_torch import convert
from mptpu_torch.losses import iterative_loss
from mptpu_torch.models import experiment as ex
from mptpu_torch.models import experiment_template as tpl
from mptpu_torch.models.splat_overfit import OverfitHierarchicalEvents, splat_loss_transform

ROOT = Path(__file__).resolve().parent.parent
N = 2**13
STEPS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(kept)


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def target():
    t = np.arange(N) / 22050
    x = (np.sin(2 * np.pi * 440 * t) * np.exp(-6 * t)
         + 0.05 * np.random.default_rng(4).standard_normal(N))
    return (x / np.abs(x).max()).astype(np.float32).reshape(1, 1, N)


def noise(i):
    return np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), i), (1, 1, N),
                                         minval=-1.0, maxval=1.0))


def test_scaffold_list_and_refusals(tmp_path):
    """A dated directory with the template, a readme and an ``__init__``,
    the experiments' ``__init__`` pointing at it, as the script scaffolds;
    the same day twice raises; a current experiment without a docstring
    does not run."""
    exps = tmp_path / "experiments"
    path = ex.new_experiment(str(exps), datetime(2026, 10, 18))
    assert path == str(exps / "e_2026_10_18")
    assert sorted(os.listdir(path)) == ["__init__.py", "experiment.py", "readme.md"]
    assert (exps / "__init__.py").read_text() == "from .e_2026_10_18 import Current  # noqa\n"
    assert Path(path, "experiment.py").read_text() == Path(tpl.__file__).read_text()
    with pytest.raises(FileExistsError):
        ex.new_experiment(str(exps), datetime(2026, 10, 18))
    ex.new_experiment(str(exps), datetime(2026, 11, 2))
    (exps / "notes").mkdir()
    assert ex.list_experiments(str(exps)) == ["e_2026_10_18", "e_2026_11_2"]
    assert ex.list_experiments(str(tmp_path / "none")) == []
    assert ex.load_current(str(exps)).__name__ == "Experiment"
    Path(path, "experiment.py").write_text("class Current:\n    def run(self):\n        pass\n")
    (exps / "__init__.py").write_text("from .e_2026_10_18 import Current  # noqa\n")
    with pytest.raises(ValueError):
        ex.run_current(str(exps))


def test_script_scaffolds_the_same_files(tmp_path, monkeypatch):
    """scripts/experiment.py's ``new_experiment`` pointed at a temporary
    directory writes the same names and readme as the port's."""
    script = load(ROOT / "scripts" / "experiment.py", "experiment_script")
    monkeypatch.setattr(script, "EXPERIMENTS_DIR", str(tmp_path / "script"))
    os.makedirs(tmp_path / "script")
    want = script.new_experiment()
    got = ex.new_experiment(str(tmp_path / "port"))
    assert os.path.basename(want) == os.path.basename(got)
    assert sorted(os.listdir(want)) == sorted(os.listdir(got))
    for name in ("__init__.py", "readme.md"):
        assert Path(want, name).read_text() == Path(got, name).read_text()
    assert (tmp_path / "script" / "__init__.py").read_text() == (
        tmp_path / "port" / "__init__.py").read_text()
    assert script.list_experiments() == ex.list_experiments(str(tmp_path / "port"))


def test_run_current_fits_on_the_corpus(tmp_path, monkeypatch):
    """The scaffolded experiment runs through ``run_current`` on the demo
    corpus (a temporary ``MPTPU_CACHE``) at 2^12 samples: finite losses,
    one a step."""
    monkeypatch.setenv("MPTPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("AUDIO_PATH", raising=False)
    exps = tmp_path / "experiments"
    path = ex.new_experiment(str(exps))
    src = Path(path, "experiment.py")
    src.write_text(src.read_text().replace("n_samples = 2 ** 15", "n_samples = 2 ** 12"))
    lines = []
    model, exp = ex.run_current(str(exps), 2, device="cpu", log=lines.append)
    assert len(exp.losses) == 2 and np.isfinite(exp.losses).all()
    assert isinstance(model, OverfitHierarchicalEvents) and lines[0].startswith("iter 0 loss")


def test_template_fit_matches_mptpus(monkeypatch):
    tgt = target()
    jtpl = load(ROOT / "experiments" / "e_2026_8_16" / "experiment.py", "e_2026_8_16_template")
    jtpl.AudioIterator = lambda *a, **k: [jnp.asarray(tgt)]

    class JSmall(jtpl.Experiment):
        n_samples = N

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_params = JSmall().run(max_iterations=STEPS)
    want0 = float(re.search(r"iter 0 loss (-?[\d.]+)", buf.getvalue()).group(1))

    jm = JModel(n_samples=N, samplerate=22050, n_events=16, context_dim=16)
    key = jax.random.PRNGKey(0)
    init = jm.init(key, key)
    model = convert.splat_from_flax(OverfitHierarchicalEvents(N, 22050, 16, 16, device="cpu"),
                                    init)
    monkeypatch.setattr(tpl, "AudioIterator", lambda *a, **k: [torch.from_numpy(tgt)])

    class Small(tpl.Experiment):
        n_samples = N

    exp = Small()
    fitted = exp.run(max_iterations=STEPS, device="cpu", model=model,
                     noise=lambda i: torch.from_numpy(noise(i)), log=lambda s: None)
    assert abs(exp.losses[0] - want0) <= 1e-4 * abs(want0) + 5e-5
    j_next = float(jax.jit(lambda p, k: j_iterative_loss(
        jnp.asarray(tgt), jm.apply(p, k)[0], j_transform))(j_params, jax.random.fold_in(key,
                                                                                       STEPS)))
    with torch.no_grad():
        recon, _, _ = fitted(noise=torch.from_numpy(noise(STEPS)))
        t_next = float(iterative_loss(torch.from_numpy(tgt), recon, splat_loss_transform))
    assert abs(t_next - j_next) <= 1e-3 * abs(j_next)
