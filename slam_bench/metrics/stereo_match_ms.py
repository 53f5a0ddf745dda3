"""stereo_match_ms: host ms per frame in the `stereo_match` span of
`slam.timer` (the row matches of a pair, `ops/stereo.py`), over the
window of a traced run; nothing where the program opens no such span."""


def read(run):
    calls, seconds = run.spans.get("stereo_match", (0, 0.0))
    return seconds * 1e3 / len(run.frame_ms) if calls else None
