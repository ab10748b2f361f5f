// The tile-planning kernels of tiles.cuh on their own, so that each can be
// launched and held against its plain PyTorch version (ops/cuda_tiles.py).
// The main path launches tile_prepare from here once per reference; K1 and
// K2 launch tile_plan (and K2 tile_prepare) from inside nn_launch and
// moments_launch, in the same host call as their sweep.
#include "tiles.cuh"

// xyz f32[batch, n, 3]; mask u8[batch, n] or null; center f32[batch, 3];
// soa f32[batch, 3, ceil(n/TP)*TP]; pmin, pmax f32[batch, ceil(n/TP), 3].
extern "C" int tile_prepare_launch(const float* xyz, const uint8_t* mask, const float* center,
                                   int batch, int n, float* soa, float* pmin, float* pmax,
                                   void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return static_cast<int>(tiles::launch_prepare(xyz, mask, center, batch, n, soa, pmin, pmax,
                                                static_cast<cudaStream_t>(stream)));
}

// xyz f32[batch, m, 3]; mask u8[batch, m] or null; center f32[batch, 3];
// pmin, pmax f32[batch, np_tiles, 3]; list i32[batch, ceil(m/TQ), np_tiles];
// count i32[batch, ceil(m/TQ)]; qmin, qmax f32[batch, ceil(m/TQ), 3].
extern "C" int tile_plan_launch(const float* xyz, const uint8_t* mask, const float* center,
                                int batch, int m, const float* pmin, const float* pmax,
                                int np_tiles, float r2_admit, int* list, int* count,
                                float* qmin, float* qmax, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  return static_cast<int>(tiles::launch_plan(xyz, mask, center, batch, m, pmin, pmax, np_tiles,
                                             r2_admit, list, count, qmin, qmax, nullptr,
                                             nullptr, static_cast<cudaStream_t>(stream)));
}
