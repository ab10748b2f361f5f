// K1: radius-bounded 1-NN over admissible ref tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nn_kernel` of
// the JAX package's ops/pallas_nn.py (called through
// `_nn_block`/`nn_pallas`).  One host call, `nn_launch`, enqueues two
// kernels: `tile_plan` (tiles.cuh: the query tiles' boxes and their lists
// of admissible ref tiles) and `nn_sweep` below.  The reference side
// (centroid, SoA rows padded with FAR, ref-tile boxes) is prepared once per
// reference by `tile_prepare`, not once per call.
//
// What bounds it on this card.  The sweep evaluates (admissible tile pairs
// x 64 x 128) candidate pairs at 8 float32 operations and a compare each
// and moves well under a megabyte, so it is bound by operations (non-tensor
// float32).  Half of the card's float32 peak is out of reach by design: the
// peak counts a fused multiply-add as two operations, and d2 must be the
// exact sum_c (q_c - p_c)^2 in the plain twin's order, so it is formed
// with the _rn intrinsics, which nvcc never contracts into FMAs.
//
// What the design does about it.
//  - The card is filled: 64-query tiles and 128-ref tiles (tighter boxes
//    admit a quarter of the pairs that the TPU kernel's 256 x 1024 tiles
//    do), and a query tile's list is cut into chunks, down to one ref tile
//    each, one block per chunk (grid.y): hundreds of blocks for 8192
//    queries, where one block per query tile would leave most of the 132
//    SMs idle and the longest list would set the time.  On this card more
//    resident warps beat more work per thread: one query per thread and
//    one ref tile per block measured faster than two queries per thread or
//    longer chunks.
//  - Refs are read from shared memory as coordinate rows (SoA), four at a
//    time with one 16-byte broadcast load per coordinate.  The sweep tracks
//    the minimum of each group of four d2 (three min operations and one
//    compare per group instead of a compare-and-select per pair) and
//    remembers the first group that lowered it; the winner inside that
//    group is found once, at the end, from the same arithmetic.
//  - Ref tiles arrive by 16-byte cp.async into a double buffer, so where a
//    block sweeps several tiles the copy of the next overlaps the sweep of
//    this one.
//  - Partial winners of the blocks that share a query tile merge by
//    atomicMin on the 64-bit key (bits of d2 << 32 | ref index): d2 >= 0,
//    so its bits order as the floats do, and equal d2 resolves to the lower
//    index - the plain twin's tie rule, whatever order the blocks finish in.
//    The result stays exact and run-to-run identical.
//  - The epilogue is in the kernel: the last block to finish a query tile
//    (a ticket counter) decodes the keys into idx int64 and d2 f32 as the
//    wrapper returns them.  The key holds the exact d2 of the winning pair,
//    so nothing is gathered or recomputed afterwards.  A query with no
//    candidate (invalid lane, or no admissible tile) gets idx 0, d2 = +inf.
#include <cuda_pipeline.h>

#include "tiles.cuh"

namespace {

using tiles::TP;
using tiles::TQ;

constexpr int THREADS = TQ;  // one query per thread
constexpr unsigned long long NO_KEY = ~0ull;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float px, float py,
                                         float pz) {
  const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py), dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Start the copy of ref tile jt (three rows of TP floats) into buf.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ soa, size_t n_pad,
                                      int jt) {
  for (int c = threadIdx.x; c < 3 * TP / 4; c += THREADS) {
    const int r = c / (TP / 4), k = c - r * (TP / 4);
    __pipeline_memcpy_async(buf + r * TP + 4 * k, soa + r * n_pad + (size_t)jt * TP + 4 * k, 16);
  }
  __pipeline_commit();
}

// grid (nq_tiles, chunks), THREADS threads.
__global__ void __launch_bounds__(THREADS)
nn_sweep_kernel(const float* __restrict__ q, const float* __restrict__ center, int m,
                const float* __restrict__ soa, int np_tiles, int n,
                const int* __restrict__ list, const int* __restrict__ count,
                unsigned long long* __restrict__ keys, int* __restrict__ tickets,
                long long* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ __align__(16) float buf[2][3 * TP];
  __shared__ bool is_last;
  const int qt = blockIdx.x, tid = threadIdx.x;
  const int cnt = count[qt];
  // Every block of a query tile derives the same split from the tile's
  // count: `active` blocks of `per` list entries each (one block, with
  // nothing to sweep, for an empty list).
  const int per = max(1, (cnt + (int)gridDim.y - 1) / (int)gridDim.y);
  const int active = max(1, (cnt + per - 1) / per);
  if ((int)blockIdx.y >= active) return;
  const int s0 = blockIdx.y * per, s1 = min(cnt, s0 + per);
  const size_t n_pad = (size_t)np_tiles * TP;

  const int qi = qt * TQ + tid;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  bool valid = false;
  if (qi < m) {
    qx = __fsub_rn(q[3 * (size_t)qi], center[0]);
    qy = __fsub_rn(q[3 * (size_t)qi + 1], center[1]);
    qz = __fsub_rn(q[3 * (size_t)qi + 2], center[2]);
    valid = fabsf(qx) < tiles::VALID_ABS;
  }
  float best = INFINITY;
  int best_group = -1;

  const int* tile_ids = list + (size_t)qt * np_tiles;
  if (s0 < s1) stage(buf[0], soa, n_pad, tile_ids[s0]);
  for (int s = s0; s < s1; ++s) {
    const float* cur = buf[(s - s0) & 1];
    if (s + 1 < s1) {
      stage(buf[(s + 1 - s0) & 1], soa, n_pad, tile_ids[s + 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int first = tile_ids[s] * TP;
    const float4* X = reinterpret_cast<const float4*>(cur);
    const float4* Y = X + TP / 4;
    const float4* Z = Y + TP / 4;
#pragma unroll 4
    for (int g = 0; g < TP / 4; ++g) {
      const float4 x = X[g], y = Y[g], z = Z[g];
      const float d0 = sq_dist(qx, qy, qz, x.x, y.x, z.x);
      const float d1 = sq_dist(qx, qy, qz, x.y, y.y, z.y);
      const float d2 = sq_dist(qx, qy, qz, x.z, y.z, z.z);
      const float d3 = sq_dist(qx, qy, qz, x.w, y.w, z.w);
      const float lowest = fminf(fminf(d0, d1), fminf(d2, d3));
      if (lowest < best) {  // strict: the first group of a tie wins
        best = lowest;
        best_group = first + 4 * g;
      }
    }
    __syncthreads();  // the sweep is done with cur before a later copy lands in it
  }

  if (valid && best_group >= 0) {
    const float4 x = *reinterpret_cast<const float4*>(soa + best_group);
    const float4 y = *reinterpret_cast<const float4*>(soa + n_pad + best_group);
    const float4 z = *reinterpret_cast<const float4*>(soa + 2 * n_pad + best_group);
    const float d0 = sq_dist(qx, qy, qz, x.x, y.x, z.x);
    const float d1 = sq_dist(qx, qy, qz, x.y, y.y, z.y);
    const float d2 = sq_dist(qx, qy, qz, x.z, y.z, z.z);
    const int j = d0 == best ? 0 : (d1 == best ? 1 : (d2 == best ? 2 : 3));
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best) << 32) | (unsigned)(best_group + j);
    atomicMin(&keys[qi], key);
  }

  // The last block to finish this query tile decodes its keys.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[qt], 1) == active - 1;
  __syncthreads();
  if (!is_last || qi >= m) return;
  __threadfence();
  const unsigned long long key = __ldcg(&keys[qi]);
  const unsigned j = (unsigned)key;
  const bool none = key == NO_KEY || j >= (unsigned)n;
  idx_out[qi] = none ? 0 : (long long)j;
  d2_out[qi] = none ? INFINITY : __uint_as_float((unsigned)(key >> 32));
}

}  // namespace

// q f32[m, 3]; center f32[3]; soa f32[3, np_tiles*TP], pmin/pmax
// f32[np_tiles, 3] from tile_prepare of the n refs; scratch: list
// i32[ceil(m/TQ), np_tiles], count and tickets i32[ceil(m/TQ)], keys
// u64[ceil(m/TQ)*TQ]; idx_out i64[m]; d2_out f32[m].  `chunks` is grid.y of
// the sweep: the most blocks one query tile's list is cut into.  `enqueued`
// (host memory, two counters: tile_plan, nn_sweep) is raised by one for each
// kernel this call put on the stream.
extern "C" int nn_launch(const float* q, int m, const float* center, const float* soa,
                         const float* pmin, const float* pmax, int np_tiles, int n,
                         float r2_admit, int chunks, int* list, int* count,
                         unsigned long long* keys, int* tickets, long long* idx_out,
                         float* d2_out, void* stream_ptr, int* enqueued) {
  if (m <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = tiles::launch_plan(q, nullptr, center, 1, m, pmin, pmax, np_tiles, r2_admit,
                                       list, count, nullptr, nullptr, keys, tickets, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++enqueued[0];
  const int nq_tiles = (m + TQ - 1) / TQ;
  nn_sweep_kernel<<<dim3(nq_tiles, chunks), THREADS, 0, stream>>>(
      q, center, m, soa, np_tiles, n, list, count, keys, tickets, idx_out, d2_out);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++enqueued[1];
  return static_cast<int>(err);
}
