"""Mean host ms of a forward + backward call over the traced slice,
outside the CUDA API calls it makes."""

from perfbench.readers import unit_host_ms as read  # noqa: F401
