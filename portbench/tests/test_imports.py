"""What a run loads: no JAX and no JAX package in the process, and a
reference that imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.small import cells

BANNED = {"jax", "jaxlib", "flax", "mptpu"}


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(run.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(run.CHECKOUT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in imports(path):
        assert name.split(".")[0] not in BANNED, f"{path}: {name}"


@pytest.mark.parametrize("path", sorted((run.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imports(path):
        assert name.split(".")[0] in {"__future__", "contextlib", "numpy", "torch"}, name


@pytest.mark.parametrize("name", cells())
def test_a_run_loads_no_jax(name):
    code = (
        "import json, sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.small import CPU, spec\n"
        f"run.execute(spec({name!r}), 3, 0.1, True, CPU)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=run.CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mptpu_torch" in loaded and not loaded & BANNED, loaded & BANNED
    assert run.BANNED == tuple(sorted(BANNED, key=["jax", "jaxlib", "flax", "mptpu"].index))
