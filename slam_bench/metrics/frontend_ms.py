"""frontend_ms: host ms per frame in the `frontend` span of `slam.timer`
(`build_frame`), over the window of a traced run."""


def read(run):
    calls, seconds = run.spans.get("frontend", (0, 0.0))
    return seconds * 1e3 / len(run.frame_ms) if calls else None
