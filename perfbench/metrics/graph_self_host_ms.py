"""Mean host ms of ``graphed.call`` a traced unit outside its child spans
(options, warm-up, capture, replay): the signature's key, the copies of
the inputs into the static ones and the clones of the outputs
(``perfbench/spans.py``)."""

from perfbench.spans import graph_self_host_ms as read  # noqa: F401
