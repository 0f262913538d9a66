"""On a card only: one short run of every cell through the command line,
and each control at the cell's own size failing its limits."""

import json
import subprocess
import sys

import pytest

from portbench import calibrate, run
from portbench.tests.small import cells, controls


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_a_short_run_is_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                         cwd=run.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name,control", controls())
def test_the_control_fails_at_full_size(card, name, control):
    spec = run.load_spec(name)
    got = calibrate.readings(spec, 2**31 + 78, 3, card, spec.entry.CONTROLS[control])["numbers"]
    assert any(got[k] > spec.limits[k] for k in got), got
