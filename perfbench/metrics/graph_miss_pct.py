"""The share of the traced ``graphed.call`` spans that hold a warm-up or a
capture: calls that missed the graph cache (``perfbench/spans.py``)."""

from perfbench.spans import graph_miss_pct as read  # noqa: F401
