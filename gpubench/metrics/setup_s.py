"""Set-up seconds: from the process's start to the window's start
(loading, the seeded inputs, the cell's own set-up and its warm-up)."""


def read(run):
    return run.setup_s
