"""Randomized geometry: the port's op against the JAX reference on the CPU.

The counterpart of ``tests/test_fuzz.py``, with its generator
(``_random_case``, seed ``1000 + seed``: ragged non-square pyramids, 1-pixel
rows and columns, odd L/P/C/H, out-of-bounds points, random padding_mode
and align_corners).  Each case goes through the JAX ``impl="reference"``
(forward and ``jax.vjp``, explicit f32 arrays: ``conftest.py`` turns on
x64) and through the port twice: ``multiscale_deformable_attention`` on CPU
tensors (the plain version, autograd for the gradients), and the custom
operator ``torch.ops.msda_tpu_torch.msda_fwd`` on CPU tensors (its CPU
implementation, and ``msda_bwd``'s through its autograd formula).
Tolerances: 1e-5 on the output, 1e-4 on the three gradients, as in the JAX
file.  The first seeds run in tier-1, the rest are marked slow.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from msda_tpu.ops import multiscale_deformable_attention as jax_msda  # noqa: E402
from msda_tpu_torch.ops import multiscale_deformable_attention  # noqa: E402
from msda_tpu_torch.ops import library  # noqa: E402
from test_fuzz import N_CASES, N_FAST, _random_case, fuzz_seeds  # noqa: E402


def _port(path, img, shapes, pts, wts, padding_mode, align_corners):
    if path == "op":
        return multiscale_deformable_attention(
            img, shapes, pts, wts, padding_mode, align_corners,
            impl="reference")
    return library.msda_fwd(img, pts, wts, library.flat_shapes(shapes),
                            padding_mode, align_corners)


@pytest.mark.parametrize("seed", fuzz_seeds(N_CASES, N_FAST))
@pytest.mark.parametrize("path", ["op", "operator"])
def test_random_geometry_matches_jax_reference(path, seed, cpu_device):
    img, shapes, pts, wts, og, padding_mode, align_corners = _random_case(
        seed)
    shapes = tuple((int(h), int(w)) for h, w in shapes)

    def f(i, p, w):
        return jax_msda(i, shapes, p, w, padding_mode, align_corners,
                        impl="reference")

    with jax.default_device(cpu_device):
        want_out, vjp = jax.vjp(f, img, pts, wts)
        want_grads = vjp(og)
    assert want_out.dtype == np.float32

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (img, pts, wts)]
    out = _port(path, leaves[0], shapes, *leaves[1:], padding_mode,
                align_corners)
    out.backward(torch.from_numpy(og))

    label = (f"seed={seed} path={path} pad={padding_mode} "
             f"align={align_corners} shapes={list(shapes)}")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5, err_msg=label)
    for name, leaf, want in zip(("img", "points", "weights"), leaves,
                                want_grads):
        assert leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4,
                                   err_msg=f"{label} {name} gradient")
