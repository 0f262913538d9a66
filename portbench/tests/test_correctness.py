"""The check that decides ``correct``, shown to fail: each control (the plain
reference one precision below the configuration, in the program's place)
and each planted fault come out not correct at every cell's committed
limits; the program itself comes out correct. At a size a CPU run holds."""

import pytest

from portbench import run
from portbench.tests.small import CPU, cells, controls, spec


def outcome(name, wrap=None, seed=2**31 + 5):
    result = run.execute(spec(name), seed, 0.2, False, CPU, wrap=wrap)
    return result["correct"], {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("name", cells())
def test_the_program_is_correct(name):
    correct, numbers = outcome(name)
    assert correct, numbers


@pytest.mark.parametrize("name,control", controls())
def test_the_control_is_not(name, control):
    s = spec(name)
    correct, numbers = outcome(name, s.entry.CONTROLS[control])
    assert not correct, numbers
    assert any(numbers[k] > 3 * s.limits[k] for k in numbers), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", cells())
def test_each_fault_is_caught(name, fault):
    s = spec(name)
    correct, numbers = outcome(name, s.entry.FAULTS[fault])
    assert not correct, numbers
