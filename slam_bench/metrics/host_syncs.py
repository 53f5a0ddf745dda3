"""host_syncs: device-to-host syncs per frame inside the entry's calls,
over the window of a traced run (torch's sync debug mode, "warn")."""


def read(run):
    frames = sum(f for _, f in run.syncs)
    return sum(s for s, _ in run.syncs) / frames if frames else None
