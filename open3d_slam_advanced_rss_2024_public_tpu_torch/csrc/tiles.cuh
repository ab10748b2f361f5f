// Tile planning shared by K1 (nn.cu) and K2 (moments.cu), for Hopper (sm_90a).
//
// Replaces the tile bookkeeping that the JAX package leaves to XLA around
// its two Pallas kernels (`_tile_aabbs` and `_admissible_lists` of
// the JAX package's ops/pallas_nn.py, the de-meaning
// and padding of `nn_pallas` and `radius_moments`).  As eager torch
// operations that bookkeeping takes about forty small launches a call and
// costs more than the sweeps themselves; here it is two kernels:
//
//   tile_prepare  (reference side, once per reference): shifts the points by
//       the centroid, sends invalid and padding lanes to FAR, writes them as
//       three coordinate rows (SoA, so a sweep reads four refs with one
//       16-byte shared load per coordinate) and reduces each TP-point tile's
//       bounding box over its valid lanes.
//   tile_plan     (query side, every call): reduces each TQ-query tile's
//       bounding box over its valid lanes, tests it against every reference
//       tile's box and writes the admissible tile ids in ascending order
//       with their count (warp ballots and a prefix count; no sort).  For K1
//       it also resets the merge keys and tickets of its query tile.
//
// Both are bound by launch latency, not by bytes or operations: they touch a
// few hundred KB.  The plain PyTorch versions are `tile_prepare_plain` and
// `tile_plan_plain` in ops/cuda_tiles.py.
//
// Invalid query lanes take no part in a box, so the centroid fill that the
// JAX wrapper needs to keep its boxes tight is gone, and a tile with no
// valid lane (an empty box) admits no pair, at max_dist inf too, where its
// infinite gap would pass the test.  The admission test
// compares the squared box gap with r2_admit, which the wrapper sets a few
// ulps above max_dist^2: a tile pair the plain test admits is always
// admitted here, whatever order the three squares are summed in.
#pragma once
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace tiles {

constexpr int TQ = 64;              // queries per tile
constexpr int TP = 128;             // refs per tile
constexpr float FAR = 3.0e7f;       // invalid / padding refs
constexpr float VALID_ABS = 1.0e7f; // |x| at or beyond this marks an invalid point

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bounding box of a block's points over its valid lanes -> box[0..2] minima,
// box[3..5] maxima (+inf / -inf for a tile with no valid lane).  Every
// thread of the block calls it; box is valid after it returns.
template <int THREADS>
__device__ __forceinline__ void block_aabb(float x, float y, float z, bool valid,
                                           float (*red)[6], float* box) {
  const float lo[3] = {valid ? x : INFINITY, valid ? y : INFINITY, valid ? z : INFINITY};
  const float hi[3] = {valid ? x : -INFINITY, valid ? y : -INFINITY, valid ? z : -INFINITY};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = warp_min(lo[c]), b = warp_max(hi[c]);
    if (lane == 0) {
      red[warp][c] = a;
      red[warp][3 + c] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < THREADS / 32; ++w)
      v = threadIdx.x < 3 ? fminf(v, red[w][threadIdx.x]) : fmaxf(v, red[w][threadIdx.x]);
    box[threadIdx.x] = v;
  }
  __syncthreads();
}

// grid (np_tiles, batch), TP threads.  xyz f32[batch, n, 3]; mask u8[batch, n]
// or null; center f32[batch, 3]; soa f32[batch, 3, np_tiles*TP];
// pmin, pmax f32[batch, np_tiles, 3].
__global__ void __launch_bounds__(TP)
tile_prepare_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                    const float* __restrict__ center, int n, int np_tiles,
                    float* __restrict__ soa, float* __restrict__ pmin,
                    float* __restrict__ pmax) {
  __shared__ float red[TP / 32][6];
  __shared__ float box[6];
  const int jt = blockIdx.x, b = blockIdx.y;
  const size_t n_pad = (size_t)np_tiles * TP;
  const size_t i = (size_t)jt * TP + threadIdx.x;
  float x = FAR, y = FAR, z = FAR;
  bool valid = false;
  if (i < (size_t)n) {
    const float* src = xyz + ((size_t)b * n + i) * 3;
    const float rx = src[0];
    valid = fabsf(rx) < VALID_ABS && (mask == nullptr || mask[(size_t)b * n + i] != 0);
    if (valid) {
      x = __fsub_rn(rx, center[3 * b]);
      y = __fsub_rn(src[1], center[3 * b + 1]);
      z = __fsub_rn(src[2], center[3 * b + 2]);
    }
  }
  float* row = soa + (size_t)b * 3 * n_pad;
  row[i] = x;
  row[n_pad + i] = y;
  row[2 * n_pad + i] = z;
  block_aabb<TP>(x, y, z, valid, red, box);
  if (threadIdx.x < 3) {
    const size_t o = ((size_t)b * np_tiles + jt) * 3 + threadIdx.x;
    pmin[o] = box[threadIdx.x];
    pmax[o] = box[3 + threadIdx.x];
  }
}

// grid (nq_tiles, batch), TQ threads.  xyz f32[batch, m, 3]; mask u8[batch, m]
// or null; center f32[batch, 3]; pmin, pmax f32[batch, np_tiles, 3];
// list i32[batch, nq_tiles, np_tiles]; count i32[batch, nq_tiles];
// qmin, qmax f32[batch, nq_tiles, 3] or null; keys u64[batch, nq_tiles*TQ]
// and tickets i32[batch, nq_tiles] or null.
__global__ void __launch_bounds__(TQ)
tile_plan_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                 const float* __restrict__ center, int m, int nq_tiles,
                 const float* __restrict__ pmin, const float* __restrict__ pmax,
                 int np_tiles, float r2_admit, int* __restrict__ list,
                 int* __restrict__ count, float* __restrict__ qmin,
                 float* __restrict__ qmax, unsigned long long* __restrict__ keys,
                 int* __restrict__ tickets) {
  __shared__ float red[TQ / 32][6];
  __shared__ float box[6];
  __shared__ int warp_count[TQ / 32];
  const int qt = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row = b * nq_tiles + qt;
  const size_t i = (size_t)qt * TQ + tid;
  float x = 0.f, y = 0.f, z = 0.f;
  bool valid = false;
  if (i < (size_t)m) {
    const float* src = xyz + ((size_t)b * m + i) * 3;
    x = __fsub_rn(src[0], center[3 * b]);
    y = __fsub_rn(src[1], center[3 * b + 1]);
    z = __fsub_rn(src[2], center[3 * b + 2]);
    valid = fabsf(x) < VALID_ABS && (mask == nullptr || mask[(size_t)b * m + i] != 0);
  }
  if (keys != nullptr) {
    keys[(size_t)row * TQ + tid] = ~0ull;
    if (tid == 0) tickets[row] = 0;
  }
  block_aabb<TQ>(x, y, z, valid, red, box);
  if (qmin != nullptr && tid < 3) {
    qmin[(size_t)row * 3 + tid] = box[tid];
    qmax[(size_t)row * 3 + tid] = box[3 + tid];
  }
  const float* bmin = pmin + (size_t)b * np_tiles * 3;
  const float* bmax = pmax + (size_t)b * np_tiles * 3;
  int* out = list + (size_t)row * np_tiles;
  const int warp = tid >> 5, lane = tid & 31;
  const bool q_empty = !(box[0] <= box[3]);
  int base = 0;
  for (int j0 = 0; j0 < np_tiles; j0 += TQ) {
    const int j = j0 + tid;
    bool adm = false;
    if (j < np_tiles && !q_empty && bmin[3 * j] <= bmax[3 * j]) {
      float lb2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gap = fmaxf(fmaxf(__fsub_rn(box[c], bmax[3 * j + c]),
                                      __fsub_rn(bmin[3 * j + c], box[3 + c])), 0.f);
        lb2 = __fadd_rn(lb2, __fmul_rn(gap, gap));
      }
      adm = lb2 <= r2_admit;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, adm);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < TQ / 32; ++w) {
      if (w < warp) before += warp_count[w];
      total += warp_count[w];
    }
    if (adm) out[base + before + __popc(ballot & ((1u << lane) - 1u))] = j;
    base += total;
    __syncthreads();
  }
  if (tid == 0) count[row] = base;
}

inline cudaError_t launch_prepare(const float* xyz, const uint8_t* mask, const float* center,
                                  int batch, int n, float* soa, float* pmin, float* pmax,
                                  cudaStream_t stream) {
  const int np_tiles = (n + TP - 1) / TP;
  tile_prepare_kernel<<<dim3(np_tiles, batch), TP, 0, stream>>>(
      xyz, mask, center, n, np_tiles, soa, pmin, pmax);
  return cudaGetLastError();
}

inline cudaError_t launch_plan(const float* xyz, const uint8_t* mask, const float* center,
                               int batch, int m, const float* pmin, const float* pmax,
                               int np_tiles, float r2_admit, int* list, int* count,
                               float* qmin, float* qmax, unsigned long long* keys,
                               int* tickets, cudaStream_t stream) {
  const int nq_tiles = (m + TQ - 1) / TQ;
  tile_plan_kernel<<<dim3(nq_tiles, batch), TQ, 0, stream>>>(
      xyz, mask, center, m, nq_tiles, pmin, pmax, np_tiles, r2_admit, list, count, qmin,
      qmax, keys, tickets);
  return cudaGetLastError();
}

}  // namespace tiles

// The constants this header was compiled with.  Each library includes the
// header in its one translation unit and so exports its own copy; the
// wrappers hold theirs against these when they load a library.
extern "C" int tile_constants(int* tq, int* tp, float* far_value, float* valid_abs) {
  *tq = tiles::TQ;
  *tp = tiles::TP;
  *far_value = tiles::FAR;
  *valid_abs = tiles::VALID_ABS;
  return 0;
}
