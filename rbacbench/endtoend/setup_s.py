"""setup_s: seconds from the process's start to the window's."""


def read(run):
    return run.setup_s
