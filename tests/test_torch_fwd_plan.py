"""K1's host-side plan (``msda_tpu_torch/csrc/msda_fwd_plan.cuh``): the
tile, point chunks, copy widths and shared memory of a launch.

The header is plain C++, so these tests compile it here with the host
compiler, once a build of launch constants (the defaults and each of
``autotune.CANDIDATES``' K1 values), into a small program that prints the
plan of each shape it reads, and hold the plans to what the kernel needs:
every shape the kernel took before its tiled design (1 to 16 levels, any
P and C) gets a plan, within the 227 KB of shared memory a block may use
on sm_90, with copies that divide the rows they copy.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import pytest

from msda_tpu_torch import autotune

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
    programs = {}

    def plan(label, defines, shapes):
        if label not in programs:
            exe = out / f"plan_{len(programs)}"
            flags = [f"-D{k}={v}" for k, v in defines.items()]
            subprocess.run([cxx, "-std=c++17", "-O1", *flags, "-I",
                            str(CSRC), "-o", str(exe),
                            str(out / "plan.cc")], check=True,
                           capture_output=True, timeout=120)
            programs[label] = exe
        text = "".join(" ".join(map(str, s)) + "\n" for s in shapes)
        run = subprocess.run([str(programs[label])], input=text,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        return [dict(zip(FIELDS, map(int, line.split())))
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
