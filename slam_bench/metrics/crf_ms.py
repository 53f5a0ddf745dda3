"""crf_ms: host ms per frame in the `spawn_flow_dyn`, `flow_evidence` and
`crf_step` spans of `slam.timer` (the LK flow gates and evidence, and the
CRF labeller), over the window of a traced run; nothing where none of
them ran (the CRF off, or a program without these spans)."""

SPANS = ("spawn_flow_dyn", "flow_evidence", "crf_step")


def read(run):
    calls, seconds = 0, 0.0
    for name in SPANS:
        c, s = run.spans.get(name, (0, 0.0))
        calls, seconds = calls + c, seconds + s
    return seconds * 1e3 / len(run.frame_ms) if calls else None
