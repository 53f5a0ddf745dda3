"""setup_s: from the process's start to the window's first frame."""


def read(run):
    return run.setup_s
