"""Seconds from the process's start to the window's first unit: imports,
kernel builds and loads, weights, input pools, warm-up and captures."""


def read(run):
    return run.setup_s
