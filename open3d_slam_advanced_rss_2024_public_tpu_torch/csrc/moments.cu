// K2: radius-neighbourhood moments (self-join) for PCA normals, for Hopper.
//
// Replaces the Pallas TPU kernel `_moments_kernel` of
// the JAX package's ops/pallas_moments.py (called
// through `radius_moments`).  For every point of each of the K scans of a
// lag block it returns the number of valid points of the same scan within
// `radius` and their covariance.  One host call, `moments_launch`, enqueues
// three kernels: `tile_prepare` and `tile_plan` (tiles.cuh: the scans as
// SoA rows with their tile boxes, and each query tile's ascending list of
// admissible ref tiles) and `moments_sweep` below.
//
// What bounds it on this card.  The sweep evaluates (admissible tile pairs
// x 64 x 128) pairs at 8 float32 operations and a compare for d2, plus 13
// instructions for the moments of an admitted pair, against about a
// megabyte moved: it is bound by operations.  As in K1, d2 is formed with
// the _rn intrinsics in the plain twin's order (no FMA), so kernel and twin
// admit exactly the same neighbours; the moments themselves use FMAs.
//
// What the design does about it.
//  - 64-query and 128-ref tiles: 128 x K blocks of two warps for 8192-point
//    scans, enough to fill 132 SMs, and tighter boxes that admit a quarter
//    of the pairs that the TPU kernel's 256 x 1024 tiles do.
//  - Refs are read from shared memory as float4 rows (three 16-byte
//    broadcast loads feed four pairs) and arrive by cp.async into a double
//    buffer, the next tile's copy under this tile's sweep.
//  - Only a few percent of the swept pairs are admitted, and the lanes of a
//    warp are Morton neighbours that admit together or not at all: the
//    moment update sits behind warp votes.  Four refs are taken at once:
//    their d2 are four independent chains, one vote on the least of them
//    skips all four with one uniform branch, and otherwise one vote per ref
//    guards its update, which is branch-free inside (multiplied by the 0/1
//    admission weight, as the plain twin does).
//  - The ten sums stay in registers and are taken of d = q - p, the offset
//    from the query: |d| <= radius keeps the second moments small, so
//    m2/n - mean mean^T does not cancel the way sums of map-frame
//    coordinates would.  (The TPU kernel's bf16 three-pass d2 and one-hot
//    matmul were workarounds for its matrix unit and are not carried over.)
//  - The epilogue is in the kernel: count f32[K, M] and cov f32[K, M, 3, 3]
//    are written as the wrapper returns them, in the plain twin's
//    arithmetic (division, then subtraction, unfused).
#include <cuda_pipeline.h>

#include "tiles.cuh"

namespace {

using tiles::TP;
using tiles::TQ;

constexpr int THREADS = TQ;  // one query per thread

__device__ __forceinline__ void stage(float* buf, const float* __restrict__ soa, size_t n_pad,
                                      int jt) {
  for (int c = threadIdx.x; c < 3 * TP / 4; c += THREADS) {
    const int r = c / (TP / 4), k = c - r * (TP / 4);
    __pipeline_memcpy_async(buf + r * TP + 4 * k, soa + r * n_pad + (size_t)jt * TP + 4 * k, 16);
  }
  __pipeline_commit();
}

struct Sums {
  float n, x, y, z, xx, xy, xz, yy, yz, zz;
};

__device__ __forceinline__ float sq_dist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Add the ref at offset (dx, dy, dz) from the query where d2 <= r2, if any
// lane of the warp admits it.
__device__ __forceinline__ void admit(Sums& s, float dx, float dy, float dz, float d2,
                                      float r2) {
  const bool admitted = d2 <= r2;
  if (!__any_sync(0xffffffffu, admitted)) return;
  const float w = admitted ? 1.f : 0.f;
  const float wx = w * dx, wy = w * dy, wz = w * dz;
  s.n += w;
  s.x += wx;
  s.y += wy;
  s.z += wz;
  s.xx = fmaf(wx, dx, s.xx);
  s.xy = fmaf(wx, dy, s.xy);
  s.xz = fmaf(wx, dz, s.xz);
  s.yy = fmaf(wy, dy, s.yy);
  s.yz = fmaf(wy, dz, s.yz);
  s.zz = fmaf(wz, dz, s.zz);
}

// Four refs at once: their d2 are independent chains, and one vote on the
// least of them skips all four where no lane of the warp admits any.
__device__ __forceinline__ void visit4(Sums& s, float qx, float qy, float qz, float4 x,
                                       float4 y, float4 z, float r2) {
  const float ax = __fsub_rn(qx, x.x), ay = __fsub_rn(qy, y.x), az = __fsub_rn(qz, z.x);
  const float bx = __fsub_rn(qx, x.y), by = __fsub_rn(qy, y.y), bz = __fsub_rn(qz, z.y);
  const float cx = __fsub_rn(qx, x.z), cy = __fsub_rn(qy, y.z), cz = __fsub_rn(qz, z.z);
  const float dx = __fsub_rn(qx, x.w), dy = __fsub_rn(qy, y.w), dz = __fsub_rn(qz, z.w);
  const float a2 = sq_dist(ax, ay, az), b2 = sq_dist(bx, by, bz);
  const float c2 = sq_dist(cx, cy, cz), d2 = sq_dist(dx, dy, dz);
  if (!__any_sync(0xffffffffu, fminf(fminf(a2, b2), fminf(c2, d2)) <= r2)) return;
  admit(s, ax, ay, az, a2, r2);
  admit(s, bx, by, bz, b2, r2);
  admit(s, cx, cy, cz, c2, r2);
  admit(s, dx, dy, dz, d2, r2);
}

// grid (nq_tiles, batch), THREADS threads.
__global__ void __launch_bounds__(THREADS)
moments_sweep_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                     const float* __restrict__ center, int m, const float* __restrict__ soa,
                     int np_tiles, const int* __restrict__ list,
                     const int* __restrict__ count, float r2, float* __restrict__ count_out,
                     float* __restrict__ cov_out) {
  __shared__ __align__(16) float buf[2][3 * TP];
  const int qt = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row = b * gridDim.x + qt;
  const size_t n_pad = (size_t)np_tiles * TP;
  const float* rows = soa + (size_t)b * 3 * n_pad;
  const int qi = qt * TQ + tid;
  // A masked or padding lane sweeps from far away: it admits nothing and
  // never holds up its warp's vote.
  float qx = -tiles::FAR, qy = -tiles::FAR, qz = -tiles::FAR;
  if (qi < m && mask[(size_t)b * m + qi] != 0) {
    const float* src = xyz + ((size_t)b * m + qi) * 3;
    qx = __fsub_rn(src[0], center[3 * b]);
    qy = __fsub_rn(src[1], center[3 * b + 1]);
    qz = __fsub_rn(src[2], center[3 * b + 2]);
  }
  Sums s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int cnt = count[row];
  const int* tile_ids = list + (size_t)row * np_tiles;
  if (cnt > 0) stage(buf[0], rows, n_pad, tile_ids[0]);
  for (int t = 0; t < cnt; ++t) {
    const float* cur = buf[t & 1];
    if (t + 1 < cnt) {
      stage(buf[(t + 1) & 1], rows, n_pad, tile_ids[t + 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float4* X = reinterpret_cast<const float4*>(cur);
    const float4* Y = X + TP / 4;
    const float4* Z = Y + TP / 4;
#pragma unroll 4
    for (int g = 0; g < TP / 4; ++g) {
      visit4(s, qx, qy, qz, X[g], Y[g], Z[g], r2);
    }
    __syncthreads();  // the sweep is done with cur before a later copy lands in it
  }
  if (qi >= m) return;
  const float denom = fmaxf(s.n, 1.f);
  const float mx = __fdiv_rn(s.x, denom), my = __fdiv_rn(s.y, denom), mz = __fdiv_rn(s.z, denom);
  const float cxx = __fsub_rn(__fdiv_rn(s.xx, denom), __fmul_rn(mx, mx));
  const float cxy = __fsub_rn(__fdiv_rn(s.xy, denom), __fmul_rn(mx, my));
  const float cxz = __fsub_rn(__fdiv_rn(s.xz, denom), __fmul_rn(mx, mz));
  const float cyy = __fsub_rn(__fdiv_rn(s.yy, denom), __fmul_rn(my, my));
  const float cyz = __fsub_rn(__fdiv_rn(s.yz, denom), __fmul_rn(my, mz));
  const float czz = __fsub_rn(__fdiv_rn(s.zz, denom), __fmul_rn(mz, mz));
  const size_t o = (size_t)b * m + qi;
  count_out[o] = s.n;
  float* cov = cov_out + o * 9;
  cov[0] = cxx; cov[1] = cxy; cov[2] = cxz;
  cov[3] = cxy; cov[4] = cyy; cov[5] = cyz;
  cov[6] = cxz; cov[7] = cyz; cov[8] = czz;
}

}  // namespace

// xyz f32[batch, m, 3]; mask u8[batch, m]; center f32[batch, 3]; scratch:
// soa f32[batch, 3, ceil(m/TP)*TP], pmin/pmax f32[batch, ceil(m/TP), 3], list
// i32[batch, ceil(m/TQ), ceil(m/TP)], count i32[batch, ceil(m/TQ)];
// count_out f32[batch, m]; cov_out f32[batch, m, 3, 3].  `enqueued` (host
// memory, three counters: tile_prepare, tile_plan, moments_sweep) is raised
// by one for each kernel this call put on the stream.
extern "C" int moments_launch(const float* xyz, const uint8_t* mask, const float* center,
                              int batch, int m, float r2, float r2_admit, float* soa,
                              float* pmin, float* pmax, int* list, int* count,
                              float* count_out, float* cov_out, void* stream_ptr,
                              int* enqueued) {
  if (batch <= 0 || m <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int np_tiles = (m + TP - 1) / TP, nq_tiles = (m + TQ - 1) / TQ;
  cudaError_t err = tiles::launch_prepare(xyz, mask, center, batch, m, soa, pmin, pmax, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++enqueued[0];
  err = tiles::launch_plan(xyz, mask, center, batch, m, pmin, pmax, np_tiles, r2_admit, list,
                           count, nullptr, nullptr, nullptr, nullptr, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++enqueued[1];
  moments_sweep_kernel<<<dim3(nq_tiles, batch), THREADS, 0, stream>>>(
      xyz, mask, center, m, soa, np_tiles, list, count, r2, count_out, cov_out);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++enqueued[2];
  return static_cast<int>(err);
}
