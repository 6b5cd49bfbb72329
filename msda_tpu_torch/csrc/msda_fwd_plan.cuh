// The host-side plan of K1 (msda_fwd.cu): the tile, the point chunks, the
// copy widths and the shared memory of one launch, from the shapes alone.
//
// Plain C++ (no CUDA header), so that the CPU tests compile it with the
// host compiler and check it over many shapes
// (tests/test_torch_fwd_plan.py).  The launch constants are compile-time
// and a build may set them (-D, msda_tpu_torch.autotune).

#pragma once

#include <cstdint>

// warps a block of K1; a block serves a tile of MSDA_FWD_WARPS * 32 / G
// tasks, one a group of G lanes
#ifndef MSDA_FWD_WARPS
#define MSDA_FWD_WARPS 4
#endif
// stages of the ring of point / weight copies (at least 2)
#ifndef MSDA_FWD_STAGES
#define MSDA_FWD_STAGES 3
#endif
// resident blocks an SM at most (fewer where registers or shared memory
// do not allow it); the grid is this many blocks a multiprocessor
#ifndef MSDA_FWD_BLOCKS_PER_SM
#define MSDA_FWD_BLOCKS_PER_SM 8
#endif
// points of a task staged at once at most; a task with more is gathered in
// chunks of this many
#ifndef MSDA_FWD_CHUNK
#define MSDA_FWD_CHUNK 32
#endif
// points whose corner loads a lane issues before their multiply-adds
#ifndef MSDA_FWD_BATCH
#define MSDA_FWD_BATCH 2
#endif
// dynamic shared memory a block of K1 may use: sm_90's 227 KB (232,448
// bytes) less 1 KB for its static shared memory (the stages' barriers)
#define MSDA_FWD_SMEM_MAX 231424

namespace msda {

// Shared bytes a task-point takes: its four corner offsets and four
// weights (32 B), and its coordinates and weight (12 B) in every stage.
constexpr int kFwdPointBytes = 32 + 12 * MSDA_FWD_STAGES;

struct FwdPlan {
  int lanes;   // G: lanes a task
  int vec;     // channels a lane and load: 4, or 1
  int tile;    // T: tasks a tile (one a group of the block)
  int chunk;   // points a chunk
  int stride;  // a task's entries in shared memory: a power of two, at
               // least 4 and the chunk
  int chunks;  // chunks a task: ceil(L * P / chunk)
  int passes;  // channel passes a tile: the channel steps when chunks > 1
               // (a pass a step, its sum kept in registers across the
               // chunks), else 1 (every step on each chunk)
  int vw_pts;  // floats a copy of the coordinates: 4, 2 or 1
  int vw_wts;  // floats a copy of the weights: 4, 2 or 1
  int smem;    // dynamic shared bytes of a block
};

inline int fwd_smem_bytes(int tile, int stride) {
  return tile * stride * kFwdPointBytes;
}

// The widest copy (4, 2 or 1 floats, up to 16 bytes) that divides a task's
// row of `row` floats and a chunk of `chunk` of them, from a base aligned to
// `align` bytes.
inline int fwd_copy_floats(int row, int chunk, int align) {
  for (int vw = 4; vw > 1; vw >>= 1) {
    if (row % vw == 0 && chunk % vw == 0 && align % (4 * vw) == 0) return vw;
  }
  return 1;
}

// L levels of P points, C channels; G lanes of `vec` channels a task (from
// msda::group_lanes and msda::vec4); the points and weights' base addresses
// aligned to pts_align and wts_align bytes.  The chunk is all L * P points
// where they fit, else the most that fit the block's shared memory, at
// most MSDA_FWD_CHUNK; a task's entries take a power of two of them
// (stride, at least 4), so that the kernel splits an entry index with a
// shift.  plan.smem is 0 where not even 4 entries a task fit (only a build
// with other constants can get there).
inline FwdPlan fwd_plan(int L, int P, int C, int G, int vec, int pts_align,
                        int wts_align) {
  FwdPlan p;
  p.lanes = G;
  p.vec = vec;
  p.tile = MSDA_FWD_WARPS * (32 / G);
  const int LP = L * P;
  int chunk = LP < MSDA_FWD_CHUNK ? LP : MSDA_FWD_CHUNK;
  int stride = 4;
  while (stride < chunk) stride <<= 1;
  while (stride > 4 && fwd_smem_bytes(p.tile, stride) > MSDA_FWD_SMEM_MAX) {
    stride >>= 1;
  }
  if (fwd_smem_bytes(p.tile, stride) > MSDA_FWD_SMEM_MAX) {
    p.chunk = p.stride = p.chunks = p.passes = p.vw_pts = p.vw_wts = 0;
    p.smem = 0;
    return p;
  }
  if (chunk > stride) chunk = stride;
  p.chunk = chunk;
  p.stride = stride;
  p.chunks = (LP + chunk - 1) / chunk;
  const int steps = (C + G * vec - 1) / (G * vec);
  p.passes = p.chunks > 1 ? steps : 1;
  p.vw_pts = fwd_copy_floats(2 * LP, 2 * chunk, pts_align);
  p.vw_wts = fwd_copy_floats(LP, chunk, wts_align);
  p.smem = fwd_smem_bytes(p.tile, p.stride);
  return p;
}

// The largest power of two (up to 16) that divides an address.
inline int fwd_alignment(uintptr_t address) {
  int a = 16;
  while (a > 1 && address % a != 0) a >>= 1;
  return a;
}

}  // namespace msda
