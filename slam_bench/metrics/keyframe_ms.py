"""keyframe_ms: host ms per keyframe in the `insert_kf` and `mapping`
spans of `slam.timer` (`insert_keyframe`, `mapping_step`), over the
window of a traced run."""


def read(run):
    n_kf, insert_s = run.spans.get("insert_kf", (0, 0.0))
    _, mapping_s = run.spans.get("mapping", (0, 0.0))
    return (insert_s + mapping_s) * 1e3 / n_kf if n_kf else None
