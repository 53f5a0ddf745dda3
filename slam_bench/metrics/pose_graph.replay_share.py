"""pose_graph.replay_share: the share (%) of the window's `pose_optimize`
calls that replayed the solve's CUDA graph (`pose_optimize.replay` spans
over `pose_optimize` spans); nothing where no `pose_optimize` span ran, or
where the program never opened a `pose_optimize.replay` or
`pose_optimize.capture` span (a program without the graph)."""


def read(run):
    calls, _ = run.spans.get("pose_optimize", (0, 0.0))
    if not calls or not {"pose_optimize.replay", "pose_optimize.capture"} & set(run.spans):
        return None
    replays, _ = run.spans.get("pose_optimize.replay", (0, 0.0))
    return 100.0 * replays / calls
