"""stereo_extract_ms: host ms per frame in the `frontend.extract` span of
`slam.timer` (both eyes of a pair through one batched `build_frames`),
over the window of a traced run; nothing where the program opens no
such span."""


def read(run):
    calls, seconds = run.spans.get("frontend.extract", (0, 0.0))
    return seconds * 1e3 / len(run.frame_ms) if calls else None
