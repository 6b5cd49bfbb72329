// The host-side plan of K2 (msda_bwd.cu): the tile, the point chunks, the
// channel steps, the copy widths, the shared memory and the tiles of one
// launch, from the shapes alone.
//
// Plain C++ (no CUDA header), so that the CPU tests compile it with the
// host compiler and check it over many shapes
// (tests/test_torch_bwd_plan.py).  The launch constants are compile-time
// and a build may set them (-D, msda_tpu_torch.autotune).

#pragma once

#include <cstdint>

#include "msda_fwd_plan.cuh"

// warps a block of K2; a block serves a tile of MSDA_BWD_WARPS * 32 / G
// tasks, one a group of G lanes
#ifndef MSDA_BWD_WARPS
#define MSDA_BWD_WARPS 4
#endif
// stages of the ring of point / weight copies (at least 2)
#ifndef MSDA_BWD_STAGES
#define MSDA_BWD_STAGES 3
#endif
// resident blocks an SM at most (fewer where registers or shared memory
// do not allow it); the grid is this many blocks a multiprocessor
#ifndef MSDA_BWD_BLOCKS_PER_SM
#define MSDA_BWD_BLOCKS_PER_SM 8
#endif
// points of a task staged at once at most; a task with more is gathered in
// chunks of this many
#ifndef MSDA_BWD_CHUNK
#define MSDA_BWD_CHUNK 32
#endif
// points whose corner loads a lane issues before their sums, and whose
// three sums the group reduces together (a power of two)
#ifndef MSDA_BWD_BATCH
#define MSDA_BWD_BATCH 4
#endif
// dynamic shared memory a block of K2 may use (as K1's: the stages'
// barriers take the rest)
#define MSDA_BWD_SMEM_MAX MSDA_FWD_SMEM_MAX

namespace msda {

// Shared bytes a task-point takes: its four corner offsets and its
// geometry (dx, dy, weight, corner mask bits) (32 B), and its coordinates
// and weight (12 B) in every stage.
constexpr int kBwdPointBytes = 32 + 12 * MSDA_BWD_STAGES;

struct BwdPlan {
  int lanes;   // G: lanes a task
  int vec;     // channels a lane and load: 4, or 1
  int tile;    // T: tasks a tile (one a group of the block)
  int chunk;   // points a chunk
  int stride;  // a task's entries in shared memory: a power of two, at
               // least 4 and the chunk
  int chunks;  // chunks a task: ceil(L * P / chunk)
  int steps;   // channel steps a lane walks for each point: 1 (the task's
               // img_grad terms merged in registers), or more past G * vec
               // channels (every point adds its own)
  int vw_pts;  // floats a copy of the coordinates: 4, 2 or 1
  int vw_wts;  // floats a copy of the weights: 4, 2 or 1
  int smem;    // dynamic shared bytes of a block
  int tiles;   // tiles of the launch: ceil(tasks / tile)
};

inline int bwd_smem_bytes(int tile, int stride) {
  return tile * stride * kBwdPointBytes;
}

// tasks = B * N * H (at most 2^31 - 1), L levels of P points, C channels;
// G lanes of `vec` channels a task (from msda::group_lanes and msda::vec4);
// the points and weights' base addresses aligned to pts_align and
// wts_align bytes.  The chunk is all L * P points where they fit, else the
// most that fit the block's shared memory, at most MSDA_BWD_CHUNK; a
// task's entries take a power of two of them (stride, at least 4).
// plan.smem is 0 where not even 4 entries a task fit (only a build with
// other constants can get there).
inline BwdPlan bwd_plan(int tasks, int L, int P, int C, int G, int vec,
                        int pts_align, int wts_align) {
  BwdPlan p;
  p.lanes = G;
  p.vec = vec;
  p.tile = MSDA_BWD_WARPS * (32 / G);
  p.steps = (C + G * vec - 1) / (G * vec);
  p.tiles = (int)(((int64_t)tasks + p.tile - 1) / p.tile);
  const int LP = L * P;
  int chunk = LP < MSDA_BWD_CHUNK ? LP : MSDA_BWD_CHUNK;
  int stride = 4;
  while (stride < chunk) stride <<= 1;
  while (stride > 4 && bwd_smem_bytes(p.tile, stride) > MSDA_BWD_SMEM_MAX) {
    stride >>= 1;
  }
  if (bwd_smem_bytes(p.tile, stride) > MSDA_BWD_SMEM_MAX) {
    p.chunk = p.stride = p.chunks = p.vw_pts = p.vw_wts = 0;
    p.smem = 0;
    return p;
  }
  if (chunk > stride) chunk = stride;
  p.chunk = chunk;
  p.stride = stride;
  p.chunks = (LP + chunk - 1) / chunk;
  p.vw_pts = fwd_copy_floats(2 * LP, 2 * chunk, pts_align);
  p.vw_wts = fwd_copy_floats(LP, chunk, wts_align);
  p.smem = bwd_smem_bytes(p.tile, p.stride);
  return p;
}

}  // namespace msda
