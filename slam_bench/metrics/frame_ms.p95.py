"""frame_ms.p95: the 95th percentile of every window frame's time from
hand-in to its pose on the host, session-initialising frames included."""

from slam_bench.yardstick import percentile


def read(run):
    return percentile(run.frame_ms, 95)
