"""readback_ms: host ms per frame in the `readback` spans of `slam.timer`
(each device-to-host read on the entry's path, where the host waits for
the device), over the window of a traced run; nothing where the program
opens no `readback` span."""


def read(run):
    calls, seconds = run.spans.get("readback", (0, 0.0))
    return seconds * 1e3 / len(run.frame_ms) if calls else None
