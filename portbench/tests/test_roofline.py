"""The frozen counts against counts made by hand at tiny shapes."""

import itertools
import math

import pytest

from portbench import roofline as rl

CELL_SHAPES = [  # (batch, atoms, samples, taps): the cells' correlations
    (32, 512, 16384, 512), (4, 512, 16384, 512), (64, 512, 16384, 512),
    *[(4, 512, s, 128) for s in (512, 1024, 2048, 4096, 8192, 16384, 32768)],
]


@pytest.mark.parametrize("n,A", [(8, 3), (5, 5), (3, 4), (16, 1)])
def test_direct_correlation_counts_overlapping_taps(n, A):
    taps = sum(1 for t, k in itertools.product(range(n), range(A)) if t + k < n)
    assert rl.correlation_direct_flops(2, 3, n, A) == 2 * 2 * 3 * taps


@pytest.mark.parametrize("A", [1, 3, 4])
def test_direct_gram_counts_every_lag(A):
    pairs = sum(1 for s in range(-(A - 1), A) for k in range(A) if 0 <= k - s < A)
    assert rl.gram_direct_flops(5, A) == 2 * 5 * 5 * pairs


def test_fft_counts_by_hand():
    L = 16   # n + A - 1 = 12 -> 16
    fft = 2.5 * L * 4
    assert rl.correlation_fft_flops(2, 3, 9, 4) == 5 * fft + 6 * (6 * 9 + fft)
    Lg = 8   # 2A - 1 = 7 -> 8
    fftg = 2.5 * Lg * 3
    assert rl.gram_fft_flops(3, 4) == 3 * fftg + 9 * (6 * 5 + fftg)


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_fft_count_is_the_smaller_at_the_cells_sizes(shape):
    B, N, n, A = shape
    assert rl.correlation_fft_flops(B, N, n, A) < rl.correlation_direct_flops(B, N, n, A)
    assert rl.correlation_flops(B, N, n, A) == rl.correlation_fft_flops(B, N, n, A)
    assert rl.gram_flops(N, A) == rl.gram_fft_flops(N, A) < rl.gram_direct_flops(N, A)


def test_loop_counts_by_hand():
    # 2 items x 3 steps, 4 atoms x 5 taps (9 lags), 20 samples
    window = 4 * 9
    assert rl.loop_bytes(4, 5, 20, 2, 3) == 4 * (6 * 3 * window + 2 * (40 + 9))
    assert rl.loop_flops(4, 5, 2, 3) == 2 * window * 6


def test_bound_takes_the_slower_of_bytes_and_operations():
    peaks = (2.0, 10.0)
    assert rl.bound_s(8.0, 10.0, peaks) == 4.0
    assert rl.bound_s(2.0, 100.0, peaks) == 10.0


def test_the_bench_loop_bound():
    """K2's bound at the bench shapes: 6.005 ms a call on an SXM H100."""
    b = rl.bound_s(rl.loop_bytes(512, 512, 16384, 32, 100), rl.loop_flops(512, 512, 32, 100),
                   rl.device_peaks("NVIDIA H100 80GB HBM3"))
    assert math.isclose(b * 1e3, 6.0051, rel_tol=1e-4)


def test_peaks_by_card_name():
    assert rl.device_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    with pytest.raises(ValueError):
        rl.device_peaks("NVIDIA H100 PCIe")
