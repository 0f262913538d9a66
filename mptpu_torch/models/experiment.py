"""Dated experiments (counterpart of ``scripts/experiment.py``): scaffold a
new experiment directory ``e_<year>_<month>_<day>`` from the template
(:mod:`.experiment_template`, a splat overfit), list the experiments, and
run the current one, which the experiments directory's ``__init__.py``
names. The caller gives the experiments directory; the port never writes
into the repository's ``experiments/``.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import zlib
from datetime import datetime
from typing import List, Optional

# the template's source, copied into each new experiment
TEMPLATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiment_template.py")


def new_experiment(experiments_dir: str, now: Optional[datetime] = None) -> str:
    """Scaffold ``experiments_dir/e_<year>_<month>_<day>`` (of ``now``, by
    default the present) with the template, a readme and an ``__init__.py``,
    and point ``experiments_dir/__init__.py`` at it; returns its path.
    Raises when it exists."""
    now = now or datetime.now()
    name = f"e_{now.year}_{now.month}_{now.day}"
    path = os.path.join(experiments_dir, name)
    if os.path.exists(path):
        raise FileExistsError(f"{path} already exists")
    os.makedirs(path)
    with open(os.path.join(path, "__init__.py"), "w") as f:
        f.write("from .experiment import Current  # noqa\n")
    with open(TEMPLATE) as src, open(os.path.join(path, "experiment.py"), "w") as f:
        f.write(src.read())
    with open(os.path.join(path, "readme.md"), "w") as f:
        f.write(f"# {name}\n\nDescribe this experiment.\n")
    with open(os.path.join(experiments_dir, "__init__.py"), "w") as f:
        f.write(f"from .{name} import Current  # noqa\n")
    return path


def list_experiments(experiments_dir: str) -> List[str]:
    """The names of the experiment directories, sorted."""
    if not os.path.isdir(experiments_dir):
        return []
    return sorted(d for d in os.listdir(experiments_dir)
                  if d.startswith("e_") and os.path.isdir(os.path.join(experiments_dir, d)))


def load_current(experiments_dir: str):
    """The class ``Current`` that ``experiments_dir/__init__.py`` names,
    imported afresh as a package of its own name (the directory's path
    decides it), so that another experiments directory is never shadowed.
    The path is made absolute: the import system caches a finder for each
    search path, and a relative one would keep the first working
    directory's."""
    experiments_dir = os.path.abspath(experiments_dir)
    init = os.path.join(experiments_dir, "__init__.py")
    name = f"_experiments_{zlib.crc32(experiments_dir.encode()):08x}"
    for key in [k for k in sys.modules if k == name or k.startswith(name + ".")]:
        del sys.modules[key]
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[experiments_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod.Current


def run_current(experiments_dir: str, max_iterations: Optional[int] = None, **kwargs):
    """Run the current experiment (``Current().run``, with ``max_iterations``
    when given and ``kwargs``); returns what it returns and the instance.
    Raises when the experiment has no docstring."""
    current = load_current(experiments_dir)
    if not (current.__doc__ or "").strip():
        raise ValueError("an experiment must have a docstring describing it")
    exp = current()
    if max_iterations is not None:
        kwargs["max_iterations"] = max_iterations
    return exp.run(**kwargs), exp
