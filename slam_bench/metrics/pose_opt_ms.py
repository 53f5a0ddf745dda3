"""pose_opt_ms: host ms per frame in the `pose_optimize` and
`pose_consensus` spans of `slam.timer` (the motion-only solver and its
audit, whoever calls them: tracking, loop verification, relocalisation),
over the window of a traced run; nothing where the program opens neither
span."""


def read(run):
    calls, seconds = 0, 0.0
    for name in ("pose_optimize", "pose_consensus"):
        c, s = run.spans.get(name, (0, 0.0))
        calls, seconds = calls + c, seconds + s
    return seconds * 1e3 / len(run.frame_ms) if calls else None
