"""The window over the forward + backward calls completed in it (calls
back to back, one synchronize at the end), in ms a call."""


def read(run):
    return run.window_s / run.units * 1e3
