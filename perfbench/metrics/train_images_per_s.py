"""Images of every step completed in the window (steps back to back, one
synchronize at the end), over the window."""

from perfbench.readers import images_per_s as read  # noqa: F401
