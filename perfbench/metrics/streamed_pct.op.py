"""The share of the op's kernel launches in the traced slice that the
router sent to the streamed kernels (the program's launch counters)."""

STREAMED = ("msda_stream_fwd", "msda_stream_bwd")
GATHER = ("msda_fwd", "msda_bwd")


def read(run):
    streamed = sum(run.launches.get(k, 0) for k in STREAMED)
    total = streamed + sum(run.launches.get(k, 0) for k in GATHER)
    return 100.0 * streamed / total if total else None
