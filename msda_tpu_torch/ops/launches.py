"""The CUDA kernel wrappers' launch counters, read through one registry.

Each wrapper module counts its own launches in ``LAUNCHES``: an int for a
module of one kernel (counted under its ``KERNEL`` name), or a dict by
kernel name for a library of several (``cuda_stream``).  It registers
itself here when it is imported, and the functions below read, add to and
reset every registered counter, so that a new wrapper needs only its own
``register(__name__)``.  A wrapper that was never imported launched
nothing, and its kernels are left out of :func:`counts`.
"""

from __future__ import annotations

import sys

__all__ = ["register", "counts", "add", "reset"]

_WRAPPERS: list[str] = []  # module names, in the order of registration


def register(module_name: str) -> None:
    """Register the wrapper module ``module_name`` (its ``__name__``)."""
    if module_name not in _WRAPPERS:
        _WRAPPERS.append(module_name)


def _counters(modules=()):
    """``(module, its LAUNCHES)`` for ``modules``, or for every registered
    wrapper."""
    for module in modules or [sys.modules[name] for name in _WRAPPERS]:
        yield module, module.LAUNCHES


def counts(*modules) -> dict:
    """The launch counts, by kernel name, of the kernels of the wrapper
    ``modules`` (every registered wrapper by default)."""
    out = {}
    for module, launched in _counters(modules):
        if isinstance(launched, dict):
            out.update(launched)
        else:
            out[module.KERNEL] = launched
    return out


def add(launched: dict) -> None:
    """Add ``launched`` (launches by kernel name) to the counters."""
    for module, counter in _counters():
        if isinstance(counter, dict):
            for name in counter:
                counter[name] += launched.get(name, 0)
        else:
            module.LAUNCHES = counter + launched.get(module.KERNEL, 0)


def reset() -> None:
    """Set every counter to 0."""
    add({name: -n for name, n in counts().items()})
