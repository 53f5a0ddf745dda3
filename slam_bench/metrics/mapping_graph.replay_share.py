"""mapping_graph.replay_share: the share (%) of the window's `mapping`
calls that replayed the mapping step's CUDA graph (`mapping.replay` spans
over `mapping` spans); nothing where no `mapping` span ran, or where the
program never opened a `mapping.replay` or `mapping.capture` span (a
program without the graph)."""


def read(run):
    calls, _ = run.spans.get("mapping", (0, 0.0))
    if not calls or not {"mapping.replay", "mapping.capture"} & set(run.spans):
        return None
    replays, _ = run.spans.get("mapping.replay", (0, 0.0))
    return 100.0 * replays / calls
