"""The yardstick's counts at each cell's sizes against hand-worked values."""

import statistics

import pytest

from benchmark import yardstick as y


@pytest.mark.parametrize("markers, ms", [(6_400_000, 0.0841), (62_500_000, 0.821)])
def test_step_need_f32_is_44_bytes_a_marker(markers, ms):
    n_bytes, n_ops = y.step_need(markers, 1, 192 if markers < 10**7 else 4096, 4, 4)
    assert n_bytes == 44 * markers
    seconds, by = y.least_seconds(n_bytes, n_ops, 4)
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(ms, abs=1.5e-4)


def test_step_need_bf16_weights_is_40_bytes_and_ops_take_the_smaller_form():
    n_bytes, n_ops = y.step_need(1000, 1, 192, 4, 2)
    assert n_bytes == 40 * 1000
    # one mode: the grid form (104 a marker plus 16 nx nmode a step) is the
    # smaller at 1000 markers, the per-mode form (140 a marker) at 10
    assert n_ops == 104 * 1000 + 16 * 192
    assert y.step_need(10, 1, 192, 4, 4)[1] == 140 * 10


def test_hist_xv_need_is_20_bytes_a_marker_and_the_histograms():
    n_bytes, n_ops = y.hist_xv_need(6_400_000, 3, 64 * 64, 4)
    assert n_bytes == 20 * 6_400_000 + 3 * 4096 * 4
    assert n_ops == 38 * 6_400_000
    seconds, by = y.least_seconds(n_bytes, n_ops, 4)
    assert by == "bytes" and seconds * 1e3 == pytest.approx(0.0382, abs=1e-4)


def test_percentile_is_linear_between_ranks():
    values = [float(v) for v in range(1, 101)]
    assert y.percentile(values, 95.0) == pytest.approx(95.05)
    assert y.percentile([3.0], 95.0) == 3.0
    assert y.percentile([1.0, 2.0], 50.0) == 1.5


def test_spread_uses_statistics_quartiles():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert y.spread(values) == (q3 - q1) / med
