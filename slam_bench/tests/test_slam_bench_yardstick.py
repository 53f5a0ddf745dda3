"""The benchmark's arithmetic: percentiles, rates, spreads, the FAST
kernel's bytes and bound, the sync count, and the trace reduction."""

import statistics
import warnings

import numpy as np
import pytest

from slam_bench import trace, yardstick


@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_is_numpys(q):
    xs = list(np.random.default_rng(3).random(37) * 1000)
    assert yardstick.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_rate_and_spread():
    assert yardstick.rate(50, 40.0) == 1.25
    with pytest.raises(ValueError):
        yardstick.rate(1, 0.0)
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == (q3 - q1) / med


def test_fast_bytes_and_bound():
    shapes = yardstick.pyramid_shapes(480, 640, 8, 1.2)
    assert shapes[0] == (480, 640) and shapes[1] == (400, 533)
    n_bytes, n_pixels = yardstick.fast_cells_bytes(shapes, 16)
    n_cells = sum(-(-h // 16) * -(-w // 16) for h, w in shapes)
    assert n_pixels == sum(h * w for h, w in shapes)
    assert n_bytes == 4 * n_pixels + 12 * n_cells
    ms, by = yardstick.bound(n_bytes, n_pixels, 0)
    assert by == "bytes"
    # PERF.md's table: 0.00115 ms for one 640x480 frame
    assert ms == pytest.approx(0.00115, rel=0.01)


def test_count_syncs():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
    assert yardstick.count_syncs(caught) == 1


def test_trace_reduction():
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("k1", 4.0, 4.5), ("k3", 9.0, 11.0)]
    host = [("slice", 0.5, 10.0), ("frame", 0.5, 5.0), ("track", 2.6, 3.9),
            ("frame", 5.0, 10.0)]
    r = trace.reduce(device, host)
    assert r["busy_s"] == pytest.approx(1.5 + 0.5 + 1.0)
    assert r["window_s"] == pytest.approx(9.5)
    assert r["kernels"]["k1"] == [2, pytest.approx(1.5)]
    assert r["device_ops"][0] == ["k1", pytest.approx(1.5)]
    # gaps: 0.5-1.0 (frame), 2.5-4.0 (track), 4.5-9.0 (frame)
    assert [g[0] for g in r["idle_gaps"]] == ["frame", "track"]
    assert r["idle_gaps"][0][1] == pytest.approx(5.0)
    assert r["idle_gaps"][1][1] == pytest.approx(1.5)


def test_trace_needs_one_slice():
    with pytest.raises(ValueError):
        trace.reduce([], [("frame", 0.0, 1.0)])
