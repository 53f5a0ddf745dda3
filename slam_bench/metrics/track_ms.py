"""track_ms: host ms per frame in the `track` span of `slam.timer`
(`track_step`), over the window of a traced run."""


def read(run):
    calls, seconds = run.spans.get("track", (0, 0.0))
    return seconds * 1e3 / len(run.frame_ms) if calls else None
