"""loop_ms: host ms per keyframe in the `loop` span of `slam.timer`
(`_try_close_loop`: detection, its fetch, and verification and
correction where a candidate qualifies), over the `insert_kf` calls of
the window of a traced run; nothing where the program opens no `loop`
span."""


def read(run):
    calls, seconds = run.spans.get("loop", (0, 0.0))
    n_kf, _ = run.spans.get("insert_kf", (0, 0.0))
    return seconds * 1e3 / n_kf if calls and n_kf else None
