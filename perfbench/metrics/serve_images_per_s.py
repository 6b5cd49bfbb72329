"""Images of every request completed in the window, over the window (each
request is synchronized, so the window holds whole requests)."""

from perfbench.readers import images_per_s as read  # noqa: F401
