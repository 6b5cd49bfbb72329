// The host-side plan of K1 (msda_fwd.cu): the tile, the point chunks, the
// copy widths and the shared memory of one launch, from the shapes alone;
// and the plan of its prologue variant, msda_fwd_queries, which stages
// rows of the query projection's output in place of points and weights,
// with the shapes it takes.
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

// The prologue variant (msda_fwd_queries in msda_fwd.cu).  Shared bytes a
// task-point takes: its four corner offsets and four weights (32 B) and its
// row of q, 3 values of `elem` bytes, in every stage; and a task its
// reference point (4 f32, 16 B) in every stage.
inline int fwd_queries_point_bytes(int elem) {
  return 32 + 3 * elem * MSDA_FWD_STAGES;
}
constexpr int kFwdQueriesTaskBytes = 16 * MSDA_FWD_STAGES;

// torch.softmax's lanes a row of n values (softmax_warp_forward): the
// next power of two of n, at most a warp.
inline int fwd_softmax_lanes(int n) {
  int lanes = 1;
  while (lanes < n && lanes < 32) lanes <<= 1;
  return lanes;
}

struct FwdQueriesPlan {
  int lanes;       // as FwdPlan's
  int vec;
  int tile;
  int stride;      // a task's entries: its softmax's lanes, a point a lane
  int q_bytes;     // bytes a copy of q's rows: 16, 8 or 4
  int ref_floats;  // floats a copy of a reference point: 4, 2 or 1
  int smem;        // dynamic shared bytes of a block; 0 where the variant
                   // does not take the shape
};

// The widest copy (16, 8 or 4 bytes) that divides a task's row of `row`
// bytes and a staged row of `pitch` bytes, from a base aligned to `align`
// bytes; 0 where none does.
inline int fwd_copy_bytes(int row, int pitch, int align) {
  for (int b = 16; b >= 4; b >>= 1) {
    if (row % b == 0 && pitch % b == 0 && align % b == 0) return b;
  }
  return 0;
}

// L levels of P points, G lanes of `vec` channels a task (as fwd_plan,
// from C); q's values of `elem` bytes from a base aligned to q_align
// bytes; reference points of R = 2 or 4 f32 whose base and strides are
// aligned to ref_align bytes.  The variant takes a shape (plan.smem > 0)
// where a task's L * P points are torch.softmax's lanes, a point a lane
// (3 to 32 points: the next power of two of L * P, at least the 4 entries
// a task takes, at most a warp), a 4-byte copy divides q's rows (always in
// f32; an even L * P in the half types) and the tile fits the block's
// shared memory (all but f32 tiles of 128 tasks, C <= 4, past 16 points).
inline FwdQueriesPlan fwd_queries_plan(int L, int P, int G, int vec,
                                       int elem, int q_align, int R,
                                       int ref_align) {
  FwdQueriesPlan p;
  p.lanes = G;
  p.vec = vec;
  p.tile = MSDA_FWD_WARPS * (32 / G);
  const int LP = L * P;
  p.stride = fwd_softmax_lanes(LP);
  p.q_bytes = fwd_copy_bytes(3 * LP * elem, 3 * p.stride * elem, q_align);
  p.ref_floats = fwd_copy_floats(R, R, ref_align);
  const int smem = p.tile * (p.stride * fwd_queries_point_bytes(elem) +
                             kFwdQueriesTaskBytes);
  const bool takes = LP >= 3 && LP <= 32 && p.q_bytes > 0 &&
                     smem <= MSDA_FWD_SMEM_MAX;
  p.smem = takes ? smem : 0;
  return p;
}

// The largest power of two (up to 16) that divides an address.
inline int fwd_alignment(uintptr_t address) {
  int a = 16;
  while (a > 1 && address % a != 0) a >>= 1;
  return a;
}

}  // namespace msda
