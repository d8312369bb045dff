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
// Design.  grid.y walks the backgrounds.  When S*C*4 bytes fit in one
// block's shared memory (164 KB at S = 40, C = 1025, after raising the
// dynamic shared-memory limit), each block keeps a private histogram
// there, strides over the pixels with shared-memory atomics, and adds its
// nonzero cells to the output with global atomics.  Otherwise it adds
// straight into the output with global atomics.
//
// What bounds it on an H100: shared-memory atomic contention on the
// popular (chunk, small count) cells, and reading 4 + 4 bytes per pixel
// and background from device memory.  A warp-private histogram is later
// work.
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void chunk_hist_smem(const int* __restrict__ oc,
                                const int* __restrict__ cid, long long n,
                                int S, int C, int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int cells = S * C;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int* cb = cid + (size_t)blockIdx.y * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = cb[i];
    const int o = oc[i];
    if ((unsigned)c < (unsigned)S && (unsigned)o < (unsigned)C)
      atomicAdd(&sh[c * C + o], 1);
  }
  __syncthreads();
  int* hb = hist + (size_t)blockIdx.y * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = sh[i];
    if (v) atomicAdd(&hb[i], v);
  }
}

__global__ void chunk_hist_global(const int* __restrict__ oc,
                                  const int* __restrict__ cid, long long n,
                                  int S, int C, int* __restrict__ hist) {
  const int* cb = cid + (size_t)blockIdx.y * n;
  int* hb = hist + (size_t)blockIdx.y * S * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = cb[i];
    const int o = oc[i];
    if ((unsigned)c < (unsigned)S && (unsigned)o < (unsigned)C)
      atomicAdd(&hb[(size_t)c * C + o], 1);
  }
}

}  // namespace

// `blocks`: the number of SMs; the private-histogram form runs about one
// block per SM in all, the global-atomic form eight per SM.
extern "C" int hp_chunk_hist(const int* oc, const int* cid, long long n,
                             int B, int S, int C, int* hist, int blocks,
                             void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long long need = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(int) * (size_t)S * C;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (smem <= (size_t)optin) {
    err = hp::prepare_smem(chunk_hist_smem, smem);
    if (err != cudaSuccess) return (int)err;
    long long gx = blocks / B;
    if (gx < 1) gx = 1;
    if (gx > need) gx = need > 0 ? need : 1;
    chunk_hist_smem<<<dim3((unsigned)gx, B), kThreads, smem, st>>>(
        oc, cid, n, S, C, hist);
  } else {
    long long gx = 8LL * blocks;
    if (gx > need) gx = need > 0 ? need : 1;
    chunk_hist_global<<<dim3((unsigned)gx, B), kThreads, 0, st>>>(
        oc, cid, n, S, C, hist);
  }
  return (int)cudaGetLastError();
}
