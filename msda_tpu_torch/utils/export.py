"""Ahead-of-time export for serving: the counterpart of
``msda_tpu/utils/export.py``, on ``torch.export``.

A deployed detector should not run the model's Python at serving time.
:func:`export_fn` traces a function (or module) with ``torch.export`` into
an ``ExportedProgram`` specialized to the example arguments' shapes,
dtypes and device, and serializes it with ``torch.export.save``; a serving
process deserializes the bytes with :func:`load_exported`, which returns the
program captured as a CUDA graph per input signature and replayed
(``utils.graphs.graphed``, the counterpart of the compiled executable that
``jax.export`` serves): the first call on the card is an eager warm-up, the
second captures the program and replays it, and each later call replays
it.  ``__wrapped__`` is the program itself, run node by node.  The model's Python constants (the level shapes, the numpy-built
encoder reference points and proposal anchors of ``models/detr.py``)
become constants of the artifact; its parameters ride in it.

    blob = export_fn(lambda *pyr: postprocess(model(list(pyr), shapes)),
                     *pyramid)
    save_exported(blob, "detector.pt2")
    serve = load_exported_file("detector.pt2")  # in the serving process
    with torch.inference_mode():
        detections = serve(*pyramid)  # a warm-up, then a capture, then replays

With ``impl="cuda"`` (or ``"auto"`` on CUDA tensors) the artifact calls
the operator ``torch.ops.msda_tpu_torch.msda_fwd`` (``ops/library.py``),
so the process that loads it must import ``msda_tpu_torch``, which
registers the operators and builds the kernels at their first call.  It
needs nothing else of the package: not the model classes, nor the code
that built the artifact.

:func:`export_fn` traces under ``torch.no_grad()``, whatever the caller's
grad mode: an artifact is for serving, so it records what an inference call
runs.  A half-type detector's residual add + LayerNorm is then the operator
``torch.ops.msda_tpu_torch.add_layer_norm`` (its fused kernel), as in the
live model under ``inference_mode``, and not the four-call chain that a
call autograd records takes (``models/detr.py``'s ``LayerNorm``).

The JAX module's ``platforms=`` and ``ignore_forward_compatibility=`` have
no counterpart: they choose the platforms a StableHLO artifact is lowered
for and work around a Mosaic lowering fault.  An ``ExportedProgram`` runs
on the device of its example arguments, and its operators are the
registered ones.

:func:`load_exported` gives the program's generated ``forward`` a frame of
its own on CPython's frame stack (:func:`_own_frame_chunk`).  CPython (3.11
on) keeps a thread's frames in chunks of 16 KiB; a frame that fits in the
current chunk but leaves less room than the frames of the functions it
calls makes every such call allocate a new chunk and free it on return
(an ``mmap`` and a ``munmap`` each).  The generated ``forward`` is one
function with a local for each node of the graph, about 1,900 for the
full-width bf16 detector (whose weight casts and their checks are half of
its nodes): called from module level, its frame left a few hundred bytes
of its chunk, and each of its operator calls paid a chunk.  A serving
process took 7-40 times the live model's request time, all of it on the
host, in the ``forward``'s own frame (``PERF.md`` §6).
"""

from __future__ import annotations

import io
import os

import torch
from torch import nn

from .graphs import graphed

__all__ = ["export_fn", "load_exported", "save_exported", "load_exported_file"]

# CPython's frame-stack chunk (DATA_STACK_CHUNK_SIZE), in 8-byte slots
_FRAME_CHUNK_SLOTS = 16 * 1024 // 8


class _Function(nn.Module):
    """An ``nn.Module`` whose forward is ``fn``, so that ``torch.export``
    can take a plain function."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, *example_args) -> bytes:
    """Serialize ``fn`` (a function or an ``nn.Module``) exported with
    ``torch.export`` at ``example_args``.

    ``example_args`` are tensors or pytrees of them (lists, tuples, dicts);
    the program is specialized to their shapes, dtypes and device.  A
    module's parameters and buffers are exported as its state; tensors that
    a function reaches through its closure (a model's parameters, say)
    become constants of the artifact.  The trace runs under
    ``torch.no_grad()``, so that the program is the one an inference call
    runs.  Returns the bytes of ``torch.export.save``.
    """
    module = fn if isinstance(fn, nn.Module) else _Function(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def _own_frame_chunk(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Regenerate ``module``'s ``forward`` with dead locals
    (``if False: _frame_pad_0 = ... = None``) up to a frame-stack chunk of
    slots, so that its frame fits in no 16 KiB chunk: CPython then starts
    it on a chunk of its own, with at least 1,000 slots of room for the
    frames it calls (``push_chunk``'s ``MINIMUM_OVERHEAD``), at one chunk
    a call instead of one for each call it makes.  What ``forward``
    computes is unchanged; a module that is not a ``GraphModule`` is
    returned as it is."""
    if not isinstance(module, torch.fx.GraphModule):
        return module
    code = type(module).forward.__code__
    pad = _FRAME_CHUNK_SLOTS - code.co_nlocals - code.co_stacksize
    if pad <= 0:
        return module
    line = ("if False: " + " = ".join(f"_frame_pad_{i}" for i in range(pad))
            + " = None\n")

    def make_transformer(current):
        return lambda body: [line, *(current(body) if current else body)]

    with module.graph.on_generate_code(make_transformer):
        module.recompile()
    return module


def _without_metadata_checks(module):
    """Erase ``module``'s ``aten._assert_tensor_metadata`` calls on tensors
    that the program makes: the checks that ``torch.export`` puts before
    each dtype cast (``Tensor.to``) that a tensor still has the dtype and
    device it had when traced.  The checks on the program's inputs stay
    (with its check of their shapes on entry); the tensors it makes follow
    from its inputs, so their checks cannot fail, and each costs an
    operator call a forward (most of the 464 in the full-width bf16
    detector, a quarter of its nodes).  A module that is not a
    ``GraphModule`` is returned as it is."""
    if not isinstance(module, torch.fx.GraphModule):
        return module
    checks = [node for node in module.graph.nodes
              if node.op == "call_function"
              and node.target is torch.ops.aten._assert_tensor_metadata.default
              and node.args[0].op != "placeholder"]
    for node in checks:
        module.graph.erase_node(node)
    if checks:
        module.recompile()
    return module


def load_exported(blob: bytes):
    """Deserialize an :func:`export_fn` artifact into a callable that takes
    the example arguments' structure: the program captured as a CUDA graph
    per input signature and replayed (``utils.graphs.graphed``; on CPU
    tensors the program itself runs).  Its ``__wrapped__`` is the program,
    without its checks of intermediate tensors' metadata
    (:func:`_without_metadata_checks`), its ``forward`` on a frame-stack
    chunk of its own (:func:`_own_frame_chunk`).  The program's checks of
    its inputs run at the warm-up and at the capture of each signature, so
    a shape the artifact was not exported for is refused as before.  The
    calling process must have imported ``msda_tpu_torch`` (this module
    does), which registers the operators the artifact calls."""
    return graphed(_own_frame_chunk(_without_metadata_checks(
        torch.export.load(io.BytesIO(blob)).module())))


def save_exported(blob: bytes, path: str | os.PathLike) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported_file(path: str | os.PathLike):
    with open(path, "rb") as f:
        return load_exported(f.read())
