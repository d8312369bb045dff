// Exact (lambda-chunk id, integer count) histogram of B backgrounds.
//
// Replaces hicpeaks_tpu/ops/pallas_hist.py::chunk_hist_pallas, which built
// the histogram from one-hot matrix products on the TPU's matrix unit.
// Here it is what it computes: an int32 histogram made with integer
// atomics, exact in any order.  Background b's chunk id c lands in row
// b*S + c of the int32 [B*S, C] output; a chunk id outside [0, S) or a
// count outside [0, C) counts nowhere.  The counts `oc` [n] are shared by
// the backgrounds (one observed sheet), the ids `cid` are [B, n].
//
// Design, for every C the scorer plans (1025 .. 131,073 columns, S = 40
// .. 56 rows, B = 2 or 4 backgrounds):
// - Read once, read wide.  A persistent grid (one 1024-thread block per SM
//   when the table fills shared memory) walks the pixels once, and a block
//   counts every background of a pixel, up to four (grid.y walks groups of
//   four), so `oc` is read once per group.  A thread takes four pixels at
//   a time with one 16-byte load per row when every row starts on a
//   16-byte boundary (n % 4 == 0, as the scorer's lane-padded bands give;
//   one pixel at a time otherwise), and loads the next four while it
//   counts these.
// - A table wider than shared memory.  The block keeps the columns below
//   Cs = min(C, 232,448 / (4 * groupB * S)) of its backgrounds' rows in
//   shared memory (726, 605, 518 columns at S = 40, 48, 56 for B = 2) and
//   counts there with shared-memory atomics; a count at or above Cs goes
//   straight to the output with a device-memory atomic.  No C falls off a
//   cliff: at real depth the counts above Cs are rare (0.07 % of the
//   increments of chr1 at o_cap 16384).
// - At the end each block adds the nonzero cells of its table to the
//   zero-filled output with device-memory atomics.
//
// What bounds it on an H100: reading 4 + 4*B bytes per pixel.  At the
// chr1 band one call, zero fill and host time included, takes within 10 %
// of one float32 torch.sum over the same input bytes, and a build that
// loaded the inputs and counted nothing took as long, so the atomics hide
// behind the loads: neither a warp-level merge of equal keys nor a per-lane copy of
// the hot low columns made it faster.  Where many counts lie above Cs (the
// synthetic cap of 131,072) the device-memory atomics of that tail bound
// it instead.  Two 16-bit counts a word would double Cs, but an atomic
// that must return the old count (to catch a wrap) waits on the hot cells:
// 75 % slower at o_cap 1024.  PERF.md section 6 has the times
// (tools/chunk_hist_ab.py).
#include <cuda_runtime.h>

#include <algorithm>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGroup = 4;     // backgrounds per block

// A block's table: rows j*S + c for background j of its group.
struct Table {
  int* sh;                    // shared [rows][Cs]: counts below Cs
  int* out;                   // device [rows][C]: the group's output rows
  int S, C, Cs;

  // One (background j, chunk c, count o) increment.
  __device__ __forceinline__ void tally(int j, int c, int o) const {
    if ((unsigned)c >= (unsigned)S || (unsigned)o >= (unsigned)C) return;
    const int row = j * S + c;
    if (o < Cs)
      atomicAdd(&sh[row * Cs + o], 1);
    else
      atomicAdd(&out[(size_t)row * C + o], 1);
  }
  __device__ __forceinline__ void tally(int j, int4 c, int4 o) const {
    tally(j, c.x, o.x);
    tally(j, c.y, o.y);
    tally(j, c.z, o.z);
    tally(j, c.w, o.w);
  }
};

__device__ __forceinline__ int4 none(const int4*) {
  return make_int4(-1, -1, -1, -1);
}
__device__ __forceinline__ int none(const int*) { return -1; }

// The pixel walk over items of T (int4: four pixels, int: one), `items`
// per row: lane `lane` of a warp takes item q0 + lane of each step and
// loads the next step's item while it counts this one.
template <int NB, typename T>
__device__ __forceinline__ void walk(const T* __restrict__ oc,
                                     const T* __restrict__ cid,
                                     long long items, int nb,
                                     long long first, long long stride,
                                     const Table& t) {
  const T nil = none(oc);
  T o_next, c_next[NB];
  auto load = [&](long long q) {
    const bool live = q < items;
    o_next = live ? __ldcs(oc + q) : nil;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      c_next[j] = live && j < nb ? __ldcs(cid + (size_t)j * items + q) : nil;
  };
  const int lane = threadIdx.x & 31;
  load(first + lane);
  for (long long q0 = first; q0 < items; q0 += stride) {
    const T o = o_next;
    T c[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) c[j] = c_next[j];
    load(q0 + stride + lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) t.tally(j, c[j], o);
  }
}

// Block (x, y) counts group y: backgrounds 4y .. 4y + 3, nb of them (fewer
// in the last group).  NB >= nb: the backgrounds the build has registers
// for.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
chunk_hist_kernel(const int* __restrict__ oc, const int* __restrict__ cid,
                  long long n, int B, int S, int C, int Cs, int vec,
                  int* __restrict__ out) {
  extern __shared__ int sh[];
  const int g0 = blockIdx.y * kGroup;
  const int nb = min(NB, B - g0);
  const int cells = nb * S * Cs;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const Table t{sh, out + (size_t)g0 * S * C, S, C, Cs};
  cid += (size_t)g0 * n;
  const long long first = (long long)blockIdx.x * blockDim.x
                          + (threadIdx.x & ~31);
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec)
    walk<NB>(reinterpret_cast<const int4*>(oc),
             reinterpret_cast<const int4*>(cid), n >> 2, nb, first, stride,
             t);
  else
    walk<NB>(oc, cid, n, nb, first, stride, t);
  __syncthreads();
  // flush the nonzero shared cells into the output
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = sh[i];
    if (v) {
      const int row = i / Cs;
      atomicAdd(&t.out[(size_t)row * C + i - row * Cs], v);
    }
  }
}

template <int NB>
cudaError_t launch(const int* oc, const int* cid, long long n, int B, int S,
                   int C, int Cs, int* hist, int blocks,
                   cudaStream_t stream) {
  auto kernel = chunk_hist_kernel<NB>;
  const size_t smem = sizeof(int) * (size_t)std::min(B, kGroup) * S * Cs;
  cudaError_t err = hp::prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = (B + kGroup - 1) / kGroup;
  const int vec = n % 4 == 0 && ((uintptr_t)oc | (uintptr_t)cid) % 16 == 0;
  const long long items = vec ? n / 4 : n;
  long long gx = std::max(1LL, (long long)blocks * per_sm / groups);
  gx = std::min(gx, (items + kThreads - 1) / kThreads);
  kernel<<<dim3((unsigned)gx, (unsigned)groups), kThreads, smem, stream>>>(
      oc, cid, n, B, S, C, Cs, vec, hist);
  return cudaGetLastError();
}

}  // namespace

// `hist` must be zero-filled and n > 0.  `blocks`: the number of SMs; the
// kernel runs as many blocks as fit on them at once.
extern "C" int hp_chunk_hist(const int* oc, const int* cid, long long n,
                             int B, int S, int C, int* hist, int blocks,
                             void* stream) {
  if (n < 1 || B < 1 || S < 1 || C < 1 || blocks < 1 ||
      (B + kGroup - 1) / kGroup > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the shared columns: as many as the group's rows leave room for
  const int nb = std::min(B, kGroup);
  const int Cs = (int)std::min<long long>(
      C, optin / ((long long)nb * S * (long long)sizeof(int)));
  // one pair's two backgrounds (the scorer's B = 2) take a build with
  // registers for two: 1-2.5 % faster than the four-background build there
  cudaStream_t st = (cudaStream_t)stream;
  err = nb <= 2 ? launch<2>(oc, cid, n, B, S, C, Cs, hist, blocks, st)
                : launch<4>(oc, cid, n, B, S, C, Cs, hist, blocks, st);
  return (int)err;
}
