"""A function of tensors captured once per input signature as a CUDA graph
and replayed: the port's counterpart of ``jax.jit``.

    serve = graphed(lambda pyr, sizes: postprocess(
        model(pyr, img_shapes), top_k=100, scoring="sigmoid",
        image_sizes=sizes))
    with torch.inference_mode():
        det = serve(pyramid, sizes)   # call 1: an eager warm-up
        det = serve(pyramid, sizes)   # call 2: the capture, and its replay
        det = serve(pyramid2, sizes)  # later calls: the inputs copied in, a replay

A signature is the structure of the arguments (``torch.utils._pytree``),
the shape, dtype and device of each tensor in them, every other leaf by
value (``top_k``, ``scoring``), and the caller's grad and inference modes.
The first call of a signature runs ``fn`` eagerly on a side stream: it
builds the kernels (``ops/_build.py`` runs ``nvcc`` at a kernel's first
launch), makes the model's shape constants (``models.attention.
device_constant``) and initialises the libraries, none of which a capture
may do.  The second clones the tensor arguments into static inputs,
captures one call of ``fn`` over them into a ``torch.cuda.CUDAGraph`` and
replays it; every later call copies the tensor arguments into the static
inputs and replays.  The outputs are cloned leaf by leaf, so that the next
replay leaves the results a caller holds alone.  Nothing in a replay
returns to the host.

Memory.  Every capture of one graphed function allocates from one memory
pool (``torch.cuda.graph_pool_handle``, made at its first capture; two
graphed functions have two pools), so that one signature's graph reuses
what another's freed: the pool holds about the largest signature's peak,
not the sum over the signatures seen, as ``jax.jit`` frees a call's
activations after it.  Two conditions make the sharing safe:

- one replay at a time, on the current stream, whose outputs are cloned
  before any other replay runs (``graphed`` does both: call it from one
  stream);
- nothing allocated during a capture is read by a later replay before that
  replay writes it.  What a replay reads before writing (a model's
  parameters, an optimizer's state, the shape constants) must exist before
  the capture, and the warm-up makes it.  A tensor first made in a capture
  and kept after it lies in the shared pool, where another signature's
  replay overwrites it: the train step's gradients, made after its
  ``zero_grad(set_to_none=True)``, are written by each replay's backward
  before its optimizer reads them, and a parameter's ``.grad`` between
  steps holds whatever the last replay left there.

Static inputs cannot share memory across signatures: each signature keeps
its own (124.5 MB for Deformable DETR's f32 pyramid at 800x1333, batch 2).
So ``graphed`` keeps at most ``max_signatures`` signatures, warmed up or
captured, and a call with a new one first drops the least recently called:
its static inputs are freed and its graph's memory goes back to the pool.
A dropped signature that returns warms up and captures again.  The default,
16, holds at most 16 x 124.5 MB = 1.99 GB of static inputs for the
full-width f32 detector at every input size of its evaluation resize
(shorter side 800, longer side at most 1333), beside the one pool.

What a graph reads, it reads where it lay at the capture: the static
inputs, and every tensor ``fn`` reaches otherwise (a model's parameters, an
optimizer's state).  Update such tensors in place (``load_state_dict``
does); ``model.to(...)`` or a parameter assigned anew after the capture
leaves the graph reading the old storage.  Host values ``fn`` reads outside
its arguments are baked in at the capture: ``options``, a function that
returns them, makes a call that finds them changed (by ``_same``) capture
again; the old graph stays until the new one is captured in the same pool.
Static inputs made under ``torch.inference_mode`` are inference tensors,
which ``copy_`` cannot write outside that mode, so the mode is part of the
signature: call a serving function in one mode.

A capture that fails raises (a host sync, a copy from pageable host memory,
a kernel build); nothing falls back to the eager call.  Tensors that lie on
no CUDA device run ``fn`` itself.  The kernels' launch counters
(``ops.launches``) are left as they were by a capture, which runs nothing,
and gain the captured launches at each replay.  ``__wrapped__`` is ``fn``;
``cache_size()`` is the number of signatures kept.

The cache, as an operator sees it.  ``stats()`` returns the function's
counters since it was made (``STATS``): ``calls`` (every call, those that
ran ``fn`` itself on no card among them), ``replays``, ``warmups`` (a
signature's first call, or its first after it was dropped: a miss),
``captures`` (every capture), ``recaptures`` (the captures that a changed
``options`` forced) and ``dropped`` (signatures dropped at
``max_signatures``).  A server over unbounded shapes reads its miss rate
there: ``warmups / calls``, each miss costing an eager call and, at the
signature's next call, a capture.

Spans (``utils.profile.annotate``: host spans, recorded only while a
profiler runs).  A call on a card runs in ``graphed.call``; inside it,
``graphed.options`` reads and compares ``options()`` (a call that finds its
signature warmed up or captured), ``graphed.warmup`` is a miss's eager
call, ``graphed.capture`` a capture and ``graphed.replay`` the replay's
launch (``cudaGraphLaunch``).  The signature's key, the copies of the
inputs and the clones of the outputs are ``graphed.call``'s own time.  A
warm-up also loads the device spans' markers (``profile.prepare_markers``),
so that a capture of ``fn``'s layer spans (``encoder``, ``decoder``,
``postprocess``, ``loss``, ``backward``, ``optimizer``) loads nothing and
every replay runs their markers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..ops import launches
from .profile import annotate, prepare_markers

__all__ = ["graphed", "STATS"]

MAX_SIGNATURES = 16  # the module docstring's arithmetic
#: the counters of ``stats()``, the module docstring's
STATS = ("calls", "replays", "warmups", "captures", "recaptures", "dropped")


def graphed(fn, options=None, max_signatures: int = MAX_SIGNATURES):
    """``fn`` captured as a CUDA graph per input signature and replayed (the
    module docstring).  ``options``: a function of no arguments returning
    the host values a capture of ``fn`` reads outside its arguments (for the
    train step, the optimizer's param groups and state); a call that finds
    them changed since its signature's capture captures again.
    ``max_signatures``: how many signatures are kept, the least recently
    called dropped first."""
    if max_signatures < 1:
        raise ValueError(f"max_signatures must be at least 1, got "
                         f"{max_signatures}")
    # signature -> None (warmed up) or the _Captured, least recently called
    # first
    graphs = OrderedDict()
    pool = None  # the handle of the function's memory pool
    counts = dict.fromkeys(STATS, 0)

    def call(*args, **kwargs):
        counts["calls"] += 1
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        device = _card(tensors)
        if device is None:
            return fn(*args, **kwargs)
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device)
                           if isinstance(x, torch.Tensor) else x
                           for x in leaves),
               torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        with annotate("graphed.call"), torch.cuda.device(device):
            if key not in graphs:
                with annotate("graphed.warmup"):
                    return warm_up(key, args, kwargs)
            graphs.move_to_end(key)
            captured = graphs[key]
            read, changed = None, False
            if options is not None:
                with annotate("graphed.options"):
                    read = options()
                    changed = (captured is not None
                               and not _same(captured.options, read))
            if captured is None or changed:
                with annotate("graphed.capture"):
                    captured = capture(key, leaves, spec, read,
                                       recapture=captured is not None)
            for static, new in zip(captured.inputs, tensors):
                static.copy_(new)
            with annotate("graphed.replay"):
                captured.graph.replay()
            counts["replays"] += 1
            launches.add(captured.launched)
            return pytree.tree_map_only(torch.Tensor, torch.clone,
                                        captured.outputs)

    def warm_up(key, args, kwargs):
        """The signature's first call: ``fn`` eagerly, on a side stream."""
        while len(graphs) >= max_signatures:
            graphs.popitem(last=False)
            counts["dropped"] += 1
        prepare_markers()  # the span markers loaded before any capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn(*args, **kwargs)
        torch.cuda.current_stream().wait_stream(side)
        graphs[key] = None
        counts["warmups"] += 1
        return out

    def capture(key, leaves, spec, read, recapture):
        nonlocal pool
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        graphs[key] = _capture(fn, leaves, spec, read, pool)
        counts["captures"] += 1
        counts["recaptures"] += recapture
        return graphs[key]

    name = getattr(fn, "__name__", type(fn).__name__)
    call.__name__ = call.__qualname__ = f"graphed_{name}"
    call.__wrapped__ = fn
    call.cache_size = lambda: len(graphs)
    call.stats = lambda: dict(counts)
    return call


def _card(tensors) -> torch.device | None:
    """The device of the first of ``tensors`` on a CUDA device, or None."""
    return next((t.device for t in tensors if t.device.type == "cuda"), None)


class _Captured(NamedTuple):
    """A captured call: the graph, its static inputs (the tensor leaves of
    the arguments, in order) and outputs, the launches that a replay issues
    (by kernel name), and what ``options`` returned at the capture."""
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: object
    launched: dict
    options: object


def _capture(fn, leaves, spec, read, pool) -> _Captured:
    """Capture one call of ``fn`` on static copies of the arguments'
    tensors, allocating from the memory pool ``pool``; ``read`` is what
    ``options`` returned for it.  The counters are left as they were, since
    the capture ran nothing."""
    static = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in leaves]
    args, kwargs = pytree.tree_unflatten(static, spec)
    graph = torch.cuda.CUDAGraph()
    before = launches.counts()
    try:
        with torch.cuda.graph(graph, pool=pool):
            outputs = fn(*args, **kwargs)
        after = launches.counts()
    finally:
        launches.add({k: before.get(k, 0) - n
                      for k, n in launches.counts().items()})
    launched = {k: n - before.get(k, 0) for k, n in after.items()}
    return _Captured(graph, [x for x in static if isinstance(x, torch.Tensor)],
                     outputs, launched, read)


def _same(a, b) -> bool:
    """Whether two readings of ``options`` (or parts of them) are the same:
    a tensor by identity (the graph reads it where it lies), anything else
    by type and value."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    if isinstance(a, dict):
        return (type(b) is dict and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same, a, b)))
    return type(a) is type(b) and a == b
