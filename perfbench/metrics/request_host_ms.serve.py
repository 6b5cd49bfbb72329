"""Mean host ms from a request's call to its return, before the
synchronize: the graphed function's signature lookup, the copy of the
inputs into its static tensors, the replay's launch and the outputs'
clones.  Over the requests of the traced run's window before the profiler
starts, whose own cost on the host would count here."""


def read(run):
    calls = run.state["call_s"][:run.traced.start]
    return sum(calls) / len(calls) * 1e3 if calls else None
