"""fps: frames whose pose reached the host, over the whole window."""

from slam_bench.yardstick import rate


def read(run):
    return rate(len(run.frame_ms), run.window_s)
