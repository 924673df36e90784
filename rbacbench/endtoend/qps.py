"""qps: queries answered in the window over the window's seconds."""


def read(run):
    return run.window.answered / run.window.seconds
