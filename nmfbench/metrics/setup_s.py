"""Process start to the window's start: imports, building or loading the
kernel library, drawing the counts, the warm scan."""


def read(run):
    return run.setup_s
