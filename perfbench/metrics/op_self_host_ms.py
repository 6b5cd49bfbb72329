"""Host ms a traced call inside the op's spans ``msda.fwd`` and
``msda.bwd`` (``ops/library.py``: the input checks, the router, the
launch), outside the CUDA API calls made in them (``perfbench/spans.py``)."""

from perfbench.spans import op_self_host_ms as read  # noqa: F401
