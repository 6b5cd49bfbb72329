"""K1's host-side plan (``msda_tpu_torch/csrc/msda_fwd_plan.cuh``): the
tile, point chunks, copy widths and shared memory of a launch; and the plan
of its prologue variant (``fwd_queries_plan``), which stages rows of the
query projection's output and reference points in place of points and
weights.

The header is plain C++, so these tests compile it here with the host
compiler, once a build of launch constants (the defaults and each of
``autotune.CANDIDATES``' K1 values), into a small program that prints the
plan of each shape it reads, and hold the plans to what the kernel needs:
every shape the kernel took before its tiled design (1 to 16 levels, any
P and C) gets a plan, within the 227 KB of shared memory a block may use
on sm_90, with copies that divide the rows they copy.  The variant takes
the shapes its plan says (3 to 32 points a head, rows of q that 4-byte
copies divide, a tile that fits), and ``cuda_fwd_queries.takes``, the
module's route, reads the same rule from a call's shapes.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import pytest

import torch

from msda_tpu_torch import autotune
from msda_tpu_torch.ops import cuda_fwd_queries

CSRC = Path(__file__).resolve().parents[1] / "msda_tpu_torch" / "csrc"
FIELDS = ("lanes", "vec", "tile", "chunk", "stride", "chunks", "passes",
          "vw_pts", "vw_wts", "smem")
SMEM_PER_BLOCK = 232448  # sm_90: 227 KB of shared memory a block
PROGRAM = r"""
#include <cstdio>
#include "msda_fwd_plan.cuh"
int main() {
  int L, P, C, G, vec, pa, wa;
  while (std::scanf("%d %d %d %d %d %d %d", &L, &P, &C, &G, &vec, &pa,
                    &wa) == 7) {
    const msda::FwdPlan p = msda::fwd_plan(L, P, C, G, vec, pa, wa);
    std::printf("%d %d %d %d %d %d %d %d %d %d\n", p.lanes, p.vec, p.tile,
                p.chunk, p.stride, p.chunks, p.passes, p.vw_pts, p.vw_wts,
                p.smem);
  }
  return 0;
}
"""
QUERIES_FIELDS = ("lanes", "vec", "tile", "stride", "q_bytes",
                  "ref_floats", "smem")
QUERIES_PROGRAM = r"""
#include <cstdio>
#include "msda_fwd_plan.cuh"
int main() {
  int L, P, G, vec, elem, qa, R, ra;
  while (std::scanf("%d %d %d %d %d %d %d %d", &L, &P, &G, &vec, &elem, &qa,
                    &R, &ra) == 8) {
    const msda::FwdQueriesPlan p =
        msda::fwd_queries_plan(L, P, G, vec, elem, qa, R, ra);
    std::printf("%d %d %d %d %d %d %d\n", p.lanes, p.vec, p.tile, p.stride,
                p.q_bytes, p.ref_floats, p.smem);
  }
  return 0;
}
"""
# K1's constants among the sweep's: each build of the tests' programs
K1_CONSTANTS = {k: v for k, v in autotune.CANDIDATES.items()
                if k.startswith("MSDA_FWD_")}
DEFAULTS = {k: v[0] for k, v in K1_CONSTANTS.items()}
BUILDS = [("default", {})] + [
    (f"{k}={v}", {k: v}) for k, values in K1_CONSTANTS.items()
    for v in values[1:]]
LEVELS = range(1, 17)
POINTS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 100, 257)
CHANNELS = (1, 2, 3, 4, 6, 30, 32, 48, 64, 128, 160, 256, 1000)


def group_lanes(C: int, vec: int) -> int:
    """msda::group_lanes: C / vec rounded up to a power of two, at most
    32."""
    g = 1
    while g * vec < C and g < 32:
        g <<= 1
    return g


@pytest.fixture(scope="module")
def planner(tmp_path_factory):
    """``plan(builds, shapes) -> {label: [plan dict per shape]}``: the
    header compiled once a build with the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan's header with")
    out = tmp_path_factory.mktemp("fwd_plan")
    (out / "plan.cc").write_text(PROGRAM)
    (out / "queries.cc").write_text(QUERIES_PROGRAM)
    programs = {}

    def plan(label, defines, shapes, queries=False):
        key = (label, queries)
        if key not in programs:
            exe = out / f"plan_{len(programs)}"
            flags = [f"-D{k}={v}" for k, v in defines.items()]
            source = out / ("queries.cc" if queries else "plan.cc")
            subprocess.run([cxx, "-std=c++17", "-O1", *flags, "-I",
                            str(CSRC), "-o", str(exe), str(source)],
                           check=True, capture_output=True, timeout=120)
            programs[key] = exe
        text = "".join(" ".join(map(str, s)) + "\n" for s in shapes)
        run = subprocess.run([str(programs[key])], input=text,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        fields = QUERIES_FIELDS if queries else FIELDS
        return [dict(zip(fields, map(int, line.split())))
                for line in run.stdout.splitlines()]

    return plan


def shapes_of(vecs=(4, 1), aligns=((16, 16),)):
    """(L, P, C, G, vec, pts_align, wts_align) over the grid; vec 4 only
    where C allows it, as the launch picks it."""
    out = []
    for L in LEVELS:
        for P in POINTS:
            for C in CHANNELS:
                for vec in vecs:
                    if vec == 4 and C % 4:
                        continue
                    for pa, wa in aligns:
                        out.append((L, P, C, group_lanes(C, vec), vec, pa,
                                    wa))
    return out


@pytest.mark.parametrize("label,defines", BUILDS,
                         ids=[label for label, _ in BUILDS])
def test_every_shape_gets_a_plan_within_shared_memory(planner, label,
                                                      defines):
    """1-16 levels, P up to 257, C up to 1000: a plan that the kernel can
    launch (none refused), inside a block's shared memory, that covers
    every point once and every channel in its passes."""
    constants = {**DEFAULTS, **defines}
    warps = constants["MSDA_FWD_WARPS"]
    stages = constants["MSDA_FWD_STAGES"]
    chunk_max = constants["MSDA_FWD_CHUNK"]
    shapes = shapes_of()
    for (L, P, C, G, vec, _, _), p in zip(shapes, planner(label, defines,
                                                          shapes),
                                          strict=True):
        what = (label, L, P, C, vec)
        LP = L * P
        assert p["smem"] > 0, what  # never refused
        assert p["smem"] + 1024 <= SMEM_PER_BLOCK, what
        assert p["lanes"] == G and p["vec"] == vec, what
        assert p["tile"] * G == warps * 32, what
        assert 1 <= p["chunk"] <= min(LP, chunk_max), what
        stride = p["stride"]
        assert stride >= max(4, p["chunk"]) and stride & (stride - 1) == 0
        assert stride == 4 or stride < 2 * p["chunk"], what
        assert p["smem"] == p["tile"] * stride * (32 + 12 * stages)
        assert p["chunks"] == -(-LP // p["chunk"]), what
        steps = -(-C // (G * vec))
        assert p["passes"] == (steps if p["chunks"] > 1 else 1), what
        if LP <= chunk_max and p["chunk"] < LP:
            # all points fit in a chunk unless shared memory is short
            assert p["tile"] * max(4, 1 << (LP - 1).bit_length()) * (
                32 + 12 * stages) + 1024 > SMEM_PER_BLOCK, what


@pytest.mark.parametrize("pts_align,wts_align",
                         [(16, 16), (8, 8), (4, 4), (16, 4), (4, 16),
                          (8, 16)])
def test_copy_widths_divide_rows_chunks_and_bases(planner, pts_align,
                                                  wts_align):
    """A copy of 4, 2 or 1 floats never crosses a task's row or chunk and
    starts on its own width: 16-byte copies only from 16-byte aligned
    bases, rows and chunks."""
    shapes = shapes_of(vecs=(4,), aligns=((pts_align, wts_align),))
    for (L, P, *_), p in zip(shapes, planner("default", {}, shapes),
                             strict=True):
        LP = L * P
        last = LP - (p["chunks"] - 1) * p["chunk"]
        # floats a point: 2 coordinates, 1 weight
        for width, per, align in ((p["vw_pts"], 2, pts_align),
                                  (p["vw_wts"], 1, wts_align)):
            assert width in (1, 2, 4)
            assert (per * LP) % width == 0
            assert (per * p["chunk"]) % width == 0
            assert (per * last) % width == 0
            assert align % (4 * width) == 0
        # the widest copy where nothing stands in the way
        if LP % 4 == 0 and p["chunk"] % 4 == 0 and wts_align == 16:
            assert p["vw_wts"] == 4
        if LP % 2 == 0 and p["chunk"] % 2 == 0 and pts_align == 16:
            assert p["vw_pts"] == 4


def test_deformable_detr_plans(planner):
    """The main path's shapes: 4 levels of 4 points at C = 32 (the encoder
    and decoder), a tile of 16 tasks in 17 KB, all 16 points at once, every
    copy 16 bytes; 16 levels of 4 points in two chunks of 32, a channel
    pass a step past 128 channels."""
    shapes = [(4, 4, 32, 8, 4, 16, 16), (4, 4, 32, 32, 1, 16, 16),
              (16, 4, 32, 8, 4, 16, 16), (16, 4, 160, 32, 4, 16, 16),
              (1, 3, 32, 8, 4, 16, 16), (16, 1, 32, 8, 4, 16, 16)]
    got = planner("default", {}, shapes)
    assert [tuple(p.values()) for p in got] == [
        (8, 4, 16, 16, 16, 1, 1, 4, 4, 17408),
        (32, 1, 4, 16, 16, 1, 1, 4, 4, 4352),
        (8, 4, 16, 32, 32, 2, 1, 4, 4, 34816),
        (32, 4, 4, 32, 32, 2, 2, 4, 4, 8704),
        (8, 4, 16, 3, 4, 1, 1, 2, 1, 4352),
        (8, 4, 16, 16, 16, 1, 1, 4, 4, 17408),
    ]


def test_launch_constants_are_guarded_and_swept():
    """Each K1 constant stands under an ``#ifndef`` guard in the header
    with the sweep's default, and the kernel takes its constants from
    there alone."""
    header = (CSRC / "msda_fwd_plan.cuh").read_text()
    for name in ("MSDA_FWD_WARPS", "MSDA_FWD_STAGES",
                 "MSDA_FWD_BLOCKS_PER_SM", "MSDA_FWD_CHUNK",
                 "MSDA_FWD_BATCH"):
        assert name in K1_CONSTANTS, name
        guard = f"#ifndef {name}\n#define {name} {K1_CONSTANTS[name][0]}\n"
        assert guard in header, name
    kernel = (CSRC / "msda_fwd.cu").read_text()
    assert "#define MSDA_FWD_" not in kernel
    assert "MSDA_WARPS_PER_BLOCK" not in kernel


def queries_shapes(elems=(4, 2), aligns=((16, 16),), refs=(2, 4)):
    """(L, P, G, vec, elem, q_align, R, ref_align) over the grid, as
    ``shapes_of`` with q's element bytes and the reference points'."""
    return [(L, P, G, vec, elem, qa, R, ra)
            for (L, P, _, G, vec, _, _) in shapes_of()
            for elem in elems for qa, ra in aligns for R in refs]


def queries_fit(LP, G, elem, warps=4, stages=3):
    """The variant's shared memory at L * P = LP points a head, if its
    tile fits a block (the plan's stride: the softmax's lanes, a point a
    lane), else None."""
    stride = max(4, 1 << (LP - 1).bit_length())
    smem = warps * (32 // G) * (stride * (32 + 3 * elem * stages)
                                + 16 * stages)
    return smem if smem + 1024 <= SMEM_PER_BLOCK else None


@pytest.mark.parametrize("label,defines", BUILDS,
                         ids=[label for label, _ in BUILDS])
def test_queries_plan_fits_every_shape(planner, label, defines):
    """The prologue variant takes exactly the shapes it was written for
    (3 to 32 points a head, rows of q that a 4-byte copy divides, a tile in
    a block's shared memory), whatever the build's chunk, and gives each a
    plan inside a block's shared memory: a task-point 32 B and 3 values of q
    a stage, a task 16 B of reference point a stage, a task's entries its
    softmax's lanes."""
    constants = {**DEFAULTS, **defines}
    warps = constants["MSDA_FWD_WARPS"]
    stages = constants["MSDA_FWD_STAGES"]
    shapes = queries_shapes()
    taken = 0
    for (L, P, G, vec, elem, _, _, _), p in zip(
            shapes, planner(label, defines, shapes, queries=True),
            strict=True):
        what = (label, L, P, G, vec, elem)
        LP = L * P
        assert p["lanes"] == G and p["vec"] == vec, what
        assert p["tile"] * G == warps * 32, what
        smem = queries_fit(LP, G, elem, warps, stages)
        wanted = 3 <= LP <= 32 and (3 * LP * elem) % 4 == 0 and smem
        assert p["smem"] == (smem if wanted else 0), what
        if wanted:
            taken += 1
            stride = p["stride"]
            assert stride == 1 << (LP - 1).bit_length() >= 4, what
            assert p["q_bytes"] in (4, 8, 16), what
    assert taken > len(shapes) // 10


@pytest.mark.parametrize("q_align,ref_align",
                         [(16, 16), (8, 8), (4, 4), (2, 16), (16, 4)])
def test_queries_copies_divide_rows_chunks_and_bases(planner, q_align,
                                                     ref_align):
    """A copy of q (16, 8 or 4 bytes) never crosses a task's row or staged
    row and starts on its own width; a shape no 4-byte copy divides is not
    taken.  A reference point's copy (4, 2 or 1 f32) divides it and its
    alignment."""
    shapes = queries_shapes(aligns=((q_align, ref_align),))
    for (L, P, _, _, elem, _, R, _), p in zip(
            shapes, planner("default", {}, shapes, queries=True),
            strict=True):
        LP = L * P
        sizes = (3 * LP * elem, 3 * p["stride"] * elem)
        width = p["q_bytes"]
        if width:
            assert width in (4, 8, 16) and q_align % width == 0
            assert all(n % width == 0 for n in sizes)
        else:
            assert p["smem"] == 0
            assert q_align < 4 or any(n % 4 for n in sizes)
        if elem == 4 and q_align >= 4:
            assert width >= 4  # f32 rows always take a copy
        rf = p["ref_floats"]
        assert rf in (1, 2, 4) and R % rf == 0 and ref_align % (4 * rf) == 0
        if ref_align == 16:
            assert rf == R  # one copy a reference point


def test_deformable_detr_queries_plans(planner):
    """The main path's shapes: 4 levels of 4 points at C = 32, bf16 and
    f32, the encoder's points (an [I, 2] array expanded over the batch: 8
    bytes apart) and the decoder's boxes; 16-byte copies of q, a tile of 16
    tasks of 16 entries; bf16 in 13.6 KB, less than K1's 17 KB.  Not taken:
    a bf16 row of 3 points (9 values, no 4-byte copy), 64 points, 2 points
    (fewer than a task's 4 entries)."""
    shapes = [(4, 4, 8, 4, 2, 16, 2, 8), (4, 4, 8, 4, 2, 16, 4, 16),
              (4, 4, 8, 4, 4, 16, 2, 8), (1, 3, 8, 4, 2, 16, 2, 8),
              (16, 4, 8, 4, 2, 16, 4, 16), (2, 1, 8, 4, 4, 16, 2, 8)]
    got = planner("default", {}, shapes, queries=True)
    assert [tuple(p.values()) for p in got] == [
        (8, 4, 16, 16, 16, 2, 13568),
        (8, 4, 16, 16, 16, 4, 13568),
        (8, 4, 16, 16, 16, 2, 18176),
        (8, 4, 16, 4, 0, 2, 0),
        (8, 4, 16, 32, 16, 4, 0),
        (8, 4, 16, 2, 8, 2, 0),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_takes_reads_the_plans_rule_from_shapes(planner, dtype):
    """``cuda_fwd_queries.takes`` (the module's route) on ``meta`` tensors
    of every grid shape, q starting at element 0 or 1 of its storage: taken
    only where the compiled plan takes the shape with 4 channels a lane
    (where C allows it) and with one, and wherever it takes it with the
    larger tile; its constants are the header's defaults."""
    header = (CSRC / "msda_fwd_plan.cuh").read_text()
    assert (cuda_fwd_queries.WARPS, cuda_fwd_queries.STAGES) == (
        DEFAULTS["MSDA_FWD_WARPS"], DEFAULTS["MSDA_FWD_STAGES"])
    assert (f"#define MSDA_FWD_SMEM_MAX {cuda_fwd_queries.SMEM_MAX}\n"
            in header)
    elem = torch.empty((), dtype=dtype).element_size()
    cases, shapes = [], []
    for L in LEVELS:
        for P in POINTS:
            for offset in (0, 1):
                q = torch.empty(L * P * 3 + offset, dtype=dtype,
                                device="meta")[offset:].view(1, 1, 1, L, P, 3)
                for C in CHANNELS:
                    img = torch.empty(1, 1, 1, C, dtype=dtype, device="meta")
                    vecs = (4, 1) if C % 4 == 0 else (1,)
                    cases.append((cuda_fwd_queries.takes(img, q), len(vecs)))
                    shapes += [(L, P, group_lanes(C, vec), vec, elem,
                                16 if offset == 0 else elem, 2, 16)
                               for vec in vecs]
    plans = iter(planner("default", {}, shapes, queries=True))
    for taken, n in cases:
        fits = [next(plans)["smem"] > 0 for _ in range(n)]
        assert taken == fits[0] and (not taken or all(fits))
    assert any(taken for taken, _ in cases)
