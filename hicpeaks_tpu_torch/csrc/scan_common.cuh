// Shared pieces of the ring-scan kernels (scan_pass_a.cu, scan_pass_b.cu).
//
// Geometry.  A pixel (d, x) of the band, d = genomic distance in bins and
// x = the left bin, reads window cell (a, b) at band[d + b - a, x + a]
// (hicpeaks_tpu/ops/scan.py header).  The ring of radius r around it is
// built from four line accumulators, each a LEFT FOLD in the order the
// JAX ring scan (and its PyTorch twin, hicpeaks_tpu_torch/ops/scan.py)
// adds them.  A left fold can be advanced one radius at a time and keeps
// its value, so each accumulator is a plane that the block advances once
// per radius and every pixel of the block shares:
//
//   Vx_r[e,t] = (Vx_{r-1}[e,t] + band[e+r, t]) + band[e-r, t]
//   Vn_r[e,t] =  Vn_{r-1}[e,t] + band[e-r, t]
//   Wx_r[e,t] = (Wx_{r-1}[e,t] + band[e-r, t+r]) + band[e+r, t-r]
//   Wq_r[e,t] =  Wq_{r-1}[e,t] + band[e-r, t+r]
//
//   ringK_r = ((Vx_r[d-r, x+r] + Vx_r[d+r, x-r]) + Wx_{r-1}[d+r, x])
//             + Wx_{r-1}[d-r, x]
//   ringQ_r = Vn_r[d-r, x+r] + Wq_{r-1}[d-r, x]
//
// Every band read outside [0, num_p) x [0, Lp) is 0, the twin's
// zero-padded shifts: each block stages a zero-filled halo tile of every
// band it reads (2*maxw rows and maxw columns beyond its pixels).  The
// planes cover only the cells their readers reach: Vx rows [d0-m, d0+TD+m)
// x columns [x0-m, x0+TX+m), Vn rows [d0-m, d0+TD) x columns [x0,
// x0+TX+m), Wx rows [d0-m, d0+TD+m) x the pixel columns, Wq rows [d0-m,
// d0+TD) x the pixel columns (m = maxw, TD x TX the pixel tile).
//
// The pool plan reaches the kernels as a program (ops/cuda_scan.py
// plan_meta) that replays it in radius order: at step r each pixel forms
// its ring values once, keeps those that a later entry re-adds in a
// register slot, and runs the plan's adds and captures scheduled at r, in
// plan order.  The library is built with --fmad=false; there are only
// adds here, and the compiler does not reassociate float adds, so every
// sum is the twin's, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hp {

constexpr int TILE_X = 32;          // pixel columns per block: the warp lanes
constexpr int TILE_D = 32;          // pixel rows per block

// Limits, mirrored and checked first in ops/cuda_scan.py.
constexpr int MAX_ENTRIES = 128;    // pool-plan entries
constexpr int MAX_P = 32;           // p values (one captured bit each)
constexpr int MAX_BG_SLOTS = 4;     // background rings re-added later
constexpr int MAX_RD_SLOTS = 2;     // Reads rings re-added later
constexpr int MAX_META = 512;       // program words (staged in shared memory)

// Program layout (ops/cuda_scan.py::plan_meta), int32 words:
//   [n_e, maxw, n_ops, 0]
//   p_idx[n_e] | cap_step[n_e] | step_off[maxw + 2] | need[maxw + 1]
//   | bg_slot[maxw + 1] | rd_slot[maxw + 1] | ops[n_ops]
// An op is kind | arg << 2: OP_BG / OP_RD add the current ring (arg 0) or
// slot arg - 1 to the background / Reads sums; OP_CAP is entry arg's
// capture test.  need[r] bit 0 / bit 1: form the background / Reads ring
// values at step r.  bg_slot[r] / rd_slot[r]: the slot that keeps ring r,
// or -1.
constexpr int OP_BG = 0, OP_RD = 1, OP_CAP = 2;
constexpr int HDR = 4;

struct Program {
  const int* w;     // the words, in shared memory
  int n_e, maxw;
  __device__ Program(const int* words)
      : w(words), n_e(words[0]), maxw(words[1]) {}
  __device__ int p_idx(int e) const { return w[HDR + e]; }
  __device__ int cap_step(int e) const { return w[HDR + n_e + e]; }
  __device__ int step_off(int s) const { return w[HDR + 2 * n_e + s]; }
  __device__ int need(int r) const {
    return w[HDR + 2 * n_e + maxw + 2 + r];
  }
  __device__ int bg_slot(int r) const {
    return w[HDR + 2 * n_e + 2 * maxw + 3 + r];
  }
  __device__ int rd_slot(int r) const {
    return w[HDR + 2 * n_e + 3 * maxw + 4 + r];
  }
  __device__ int op(int k) const { return w[HDR + 2 * n_e + 4 * maxw + 5 + k]; }
};

// Plane and tile shapes for halo m.
struct Geom {
  int m;
  int TR, TC;   // band tile: TILE_D + 4m rows, TILE_X + 2m columns
  int VR;       // Vx and Wx rows: TILE_D + 2m (Vx has TC columns)
  int NR, NC;   // Vn: TILE_D + m rows, TILE_X + m columns (Wq: NR rows)
  __host__ __device__ explicit Geom(int maxw)
      : m(maxw), TR(TILE_D + 4 * maxw), TC(TILE_X + 2 * maxw),
        VR(TILE_D + 2 * maxw), NR(TILE_D + maxw), NC(TILE_X + maxw) {}
  __host__ __device__ int tile() const { return TR * TC; }
  __host__ __device__ int vx() const { return VR * TC; }
  __host__ __device__ int vn() const { return NR * NC; }
  __host__ __device__ int wx() const { return VR * TILE_X; }
  __host__ __device__ int wq() const { return NR * TILE_X; }
};

// i / w for the small non-negative i and w of a block's regions (i < 2^16,
// 2 <= w < 2^8), as a multiply-high by ceil(2^32 / w): the error,
// i / 2^32, stays below the 1/w gap to the next integer.
struct Div {
  unsigned magic;
  int w;
  __device__ explicit Div(int width)
      : magic(0xFFFFFFFFu / (unsigned)width + 1u), w(width) {}
  __device__ int operator()(int i) const {
    return (int)__umulhi((unsigned)i, magic);
  }
};

// Zero-filled halo tile of one band: `rows` rows from d0 - 2m (all TR of
// them, or the TILE_D + 2m that the Reads planes reach), columns
// [x0 - m, x0 + TILE_X + m), copied by cp.async (4 bytes a thread,
// coalesced along the lanes; a source size of 0 writes the zero of an
// out-of-band cell), so every thread starts all of its copies before any
// completes.  The caller commits and waits (cp_async_wait).
__device__ inline void load_tile_strided(float* s,
                                         const float* __restrict__ band,
                                         int num_p, int Lp, int d0, int x0,
                                         const Geom& g, int rows,
                                         int stride) {
  const Div div(g.TC);
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * g.TC;
       i += nt) {
    const int r = div(i), c = i - r * g.TC;
    const int gd = d0 - 2 * g.m + r, gx = x0 - g.m + c;
    const bool ok = gd >= 0 && gd < num_p && gx >= 0 && gx < Lp;
    const float* src = ok ? band + (size_t)gd * Lp + gx : band;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s + i * stride);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

// The same tile of two bands interleaved: a.x and b.y of each float2.
__device__ inline void load_tile2(float2* s, const float* __restrict__ a,
                                  const float* __restrict__ b, int num_p,
                                  int Lp, int d0, int x0, const Geom& g) {
  load_tile_strided(reinterpret_cast<float*>(s), a, num_p, Lp, d0, x0, g,
                    g.TR, 2);
  load_tile_strided(reinterpret_cast<float*>(s) + 1, b, num_p, Lp, d0, x0,
                    g, g.TR, 2);
}

// Waits for this thread's cp.async copies; a __syncthreads() must follow
// before other threads read them.
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ inline void load_tile(float* s, const float* __restrict__ band,
                                 int num_p, int Lp, int d0, int x0,
                                 const Geom& g, int rows) {
  load_tile_strided(s, band, num_p, Lp, d0, x0, g, rows, 1);
}

// Copies n words of global memory into shared memory, block-wide.
template <typename T>
__device__ inline void stage(T* dst, const T* __restrict__ src, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) dst[i] = src[i];
}

__device__ inline void zero(float* s, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) s[i] = 0.f;
}

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
