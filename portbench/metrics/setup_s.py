"""Process start to the first timed call: imports, inputs, the program's
set-up, kernel builds on a first run, and the warm-up calls."""


def read(run):
    return run.setup_s
