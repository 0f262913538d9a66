"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout. Tests marked ``card`` need a CUDA card and skip
without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
