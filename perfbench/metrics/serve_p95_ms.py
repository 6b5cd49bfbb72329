"""The 95th percentile of every request's latency in the window: the
host's clock from the call to the return of the synchronize after it."""

import statistics


def read(run):
    latency = run.state["latency_s"]
    if len(latency) < 20:
        return None
    return statistics.quantiles(latency, n=20, method="inclusive")[18] * 1e3
