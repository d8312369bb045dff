// Shared pieces of the ring-scan kernels (scan_pass_a.cu, scan_pass_b.cu).
//
// Geometry.  A pixel (d, x) of the band, d = genomic distance in bins and
// x = the left bin, reads window cell (a, b) at band[d + b - a, x + a]
// (hicpeaks_tpu/ops/scan.py header).  The ring of radius r around it is
// built from four line accumulators, each a LEFT FOLD in the order the
// JAX ring scan (and its PyTorch twin, hicpeaks_tpu_torch/ops/scan.py)
// adds them:
//
//   Vx_r[e,t] = fold_{b=1..r} (v + band[e+b, t]) + band[e-b, t]
//   Vn_r[e,t] = fold_{b=1..r}  v + band[e-b, t]
//   Wx_r[e,t] = fold_{a=1..r} (v + band[e-a, t+a]) + band[e+a, t-a]
//   Wq_r[e,t] = fold_{a=1..r}  v + band[e-a, t+a]
//
//   ringK_r = ((Vx_r[d-r, x+r] + Vx_r[d+r, x-r]) + Wx_{r-1}[d+r, x])
//             + Wx_{r-1}[d-r, x]
//   ringQ_r = Vn_r[d-r, x+r] + Wq_{r-1}[d-r, x]
//
// Every read outside [0, num_p) x [0, Lp) is 0, the twin's zero-padded
// shifts.  The reads reach 2*maxw rows and maxw columns from the pixel,
// so each block stages a zero-filled halo tile of that size in shared
// memory and every thread recomputes its own folds from the tile: no
// state crosses threads or blocks, and the add order is the twin's by
// construction.  The library is built with --fmad=false; there are no
// multiplies here, and the compiler does not reassociate float adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hp {

constexpr int TILE_X = 32;          // pixel columns per block: one warp
constexpr int TILE_D = 16;          // pixel rows per block
constexpr int MAX_ENTRIES = 128;    // pool-plan entries (ops/cuda_scan.py)

// Pool plan laid out by ops/cuda_scan.py::plan_meta:
// [p_idx | bg_off | bg_len | rd_off | rd_len] (n_e each), then the rings.
struct Plan {
  const int* meta;
  int n_e;
  __device__ int p_idx(int e) const { return meta[e]; }
  __device__ int bg_off(int e) const { return meta[n_e + e]; }
  __device__ int bg_len(int e) const { return meta[2 * n_e + e]; }
  __device__ int rd_off(int e) const { return meta[3 * n_e + e]; }
  __device__ int rd_len(int e) const { return meta[4 * n_e + e]; }
  __device__ int ring(int k) const { return meta[k]; }
};

__host__ __device__ inline int tile_rows(int maxw) { return TILE_D + 4 * maxw; }
__host__ __device__ inline int tile_cols(int maxw) { return TILE_X + 2 * maxw; }

// Zero-filled halo tile of one band: rows [d0 - 2maxw, d0 + TILE_D + 2maxw),
// columns [x0 - maxw, x0 + TILE_X + maxw).
__device__ inline void load_tile(float* s, const float* __restrict__ band,
                                 int num_p, int Lp, int d0, int x0,
                                 int maxw) {
  const int tw = tile_cols(maxw);
  const int n = tile_rows(maxw) * tw;
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += nt) {
    const int r = i / tw;
    const int c = i - r * tw;
    const int gd = d0 - 2 * maxw + r;
    const int gx = x0 - maxw + c;
    s[i] = (gd >= 0 && gd < num_p && gx >= 0 && gx < Lp)
               ? band[(size_t)gd * Lp + gx]
               : 0.f;
  }
}

// A band tile and the folds over it; (e, t) are tile coordinates.
struct Tile {
  const float* s;
  int tw;
  __device__ float at(int e, int t) const { return s[e * tw + t]; }

  __device__ float vx(int e, int t, int r) const {
    float v = 0.f;
    for (int b = 1; b <= r; ++b) {
      v = v + at(e + b, t);
      v = v + at(e - b, t);
    }
    return v;
  }
  __device__ float vn(int e, int t, int r) const {
    float v = 0.f;
    for (int b = 1; b <= r; ++b) v = v + at(e - b, t);
    return v;
  }
  __device__ float wx(int e, int t, int r) const {
    float v = 0.f;
    for (int a = 1; a <= r; ++a) {
      v = v + at(e - a, t + a);
      v = v + at(e + a, t - a);
    }
    return v;
  }
  __device__ float wq(int e, int t, int r) const {
    float v = 0.f;
    for (int a = 1; a <= r; ++a) v = v + at(e - a, t + a);
    return v;
  }
  // Donut ring (all non-cross cells at radius r) of the pixel at (pr, pc).
  __device__ float ringK(int pr, int pc, int r) const {
    const float a = vx(pr - r, pc + r, r);
    const float b = vx(pr + r, pc - r, r);
    const float c = wx(pr + r, pc, r - 1);
    const float d = wx(pr - r, pc, r - 1);
    return ((a + b) + c) + d;
  }
  // Lower-left quadrant ring at radius r.
  __device__ float ringQ(int pr, int pc, int r) const {
    const float a = vn(pr - r, pc + r, r);
    const float b = wq(pr - r, pc, r - 1);
    return a + b;
  }
};

// Opt in to more than 48 KB of dynamic shared memory where a launch needs
// it; returns a CUDA error code (0 on success).
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace hp
