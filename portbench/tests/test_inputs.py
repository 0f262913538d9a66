"""The traffic generators: the same seed gives the same bits, another seed
other numbers."""

import pytest
import torch

from portbench import inputs
from portbench.tests.small import CPU, cells, spec


def batches(name, seed, index):
    s = spec(name)
    entry = s.entry.Entry(s.config, s.traffic, seed, CPU)
    return entry.signal(index)


@pytest.mark.parametrize("name", cells())
def test_batches_repeat_by_seed_and_differ_across_seeds(name):
    seed = 2**31 + 12345
    a = batches(name, seed, 0)
    assert torch.equal(a, batches(name, seed, 0))
    assert not torch.equal(a, batches(name, seed + 1, 0))
    assert not torch.equal(a, batches(name, seed, 1))
    assert torch.isfinite(a).all()


def test_stream_seeds_take_large_seeds():
    big = 2**40 + 3
    assert inputs.stream_seed(big, "batch", 0) != inputs.stream_seed(big + 1, "batch", 0)
    assert 0 <= inputs.stream_seed(big, "batch", 0) < 2**63


def test_planted_batch_ends_in_a_clipped_atom():
    """With the interior plants at amplitude 0 and no noise, what is left is
    each item's clipped plant: the first ``clip_taps`` taps of one atom at
    the item's clip amplitude, at the very end."""
    gen = inputs.generator(7, "t", 0, CPU)
    d = inputs.unit_rows(torch.randn(16, 128, generator=torch.Generator().manual_seed(0)))
    spec_ = dict(kind="planted", extra_plants=2, amp0=0.0, decay=0.97, clip_taps=50,
                 clip_amps=[20.0, 6.0], noise=0.0)
    sig = inputs.signal_batch(spec_, batch=2, n_samples=1024, n_steps=4, gen=gen, device=CPU,
                              dictionary=d)
    assert sig.shape == (2, 1, 1024)
    assert not sig[:, 0, :-50].any()
    for item, amp in ((0, 20.0), (1, 6.0)):
        tail = sig[item, 0, -50:]
        assert any(torch.allclose(tail, amp * d[a, :50]) for a in range(16))
