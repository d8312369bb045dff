// Pass A of the ring scan: freeze counts.
//
// Replaces hicpeaks_tpu/ops/pallas_scan.py::scan_pass_a_pallas.  For every
// pool-plan entry it counts the candidate pixels whose lower-left "Reads"
// sum of the raw band first reaches `thr` at that entry for that entry's
// p (hicpeaks_tpu/ops/scan.py::_scan_core without captures).
//
// Design.  One thread per pixel; each block stages a zero-filled halo tile
// of `raw` (2*maxw rows, maxw columns each side, scan_common.cuh) in
// shared memory, and each candidate thread replays the plan: it keeps its
// Reads sum and one captured bit per p in registers.  Raw counts are
// integers below 2^24, so the sum is exact in any order.  Per-entry counts
// are reduced with a warp ballot into shared memory, then added to the
// int32 [n_entries] output with one atomicAdd per block and entry.
//
// What bounds it on an H100: shared-memory reads of the folds, about
// 2*r reads per ring of radius r per candidate pixel; the raw band is read
// from device memory once per tile (plus its halo).  The atomics touch
// n_entries addresses once per block.
#include "scan_common.cuh"

namespace {

__global__ void scan_pass_a_kernel(const float* __restrict__ raw,
                                   const uint8_t* __restrict__ cand,
                                   int num_p, int Lp,
                                   const int* __restrict__ meta, int n_e,
                                   int maxw, float thr,
                                   int* __restrict__ counts) {
  extern __shared__ float s_raw[];
  __shared__ int s_counts[hp::MAX_ENTRIES];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < n_e; k += blockDim.x * blockDim.y) s_counts[k] = 0;

  const int d0 = blockIdx.y * hp::TILE_D;
  const int x0 = blockIdx.x * hp::TILE_X;
  hp::load_tile(s_raw, raw, num_p, Lp, d0, x0, maxw);
  __syncthreads();

  const int d = d0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  const bool active = d < num_p && x < Lp && cand[(size_t)d * Lp + x];
  const hp::Tile T{s_raw, hp::tile_cols(maxw)};
  const hp::Plan plan{meta, n_e};
  const int pr = threadIdx.y + 2 * maxw;
  const int pc = threadIdx.x + maxw;

  float accR = 0.f;
  unsigned captured = 0u;
  for (int e = 0; e < n_e; ++e) {
    bool newly = false;
    if (active) {
      const int off = plan.rd_off(e);
      for (int k = 0; k < plan.rd_len(e); ++k)
        accR = accR + T.ringQ(pr, pc, plan.ring(off + k));
      const unsigned bit = 1u << plan.p_idx(e);
      newly = !(captured & bit) && accR >= thr;
      if (newly) captured |= bit;   // pass A: every entry is allowed
    }
    // blockDim.x == 32: each warp is one tile row, all lanes reach here
    const unsigned m = __ballot_sync(0xffffffffu, newly);
    if (threadIdx.x == 0 && m) atomicAdd(&s_counts[e], __popc(m));
  }
  __syncthreads();
  for (int k = tid; k < n_e; k += blockDim.x * blockDim.y)
    if (s_counts[k]) atomicAdd(&counts[k], s_counts[k]);
}

}  // namespace

extern "C" int hp_scan_pass_a(const float* raw, const uint8_t* cand,
                              int num_p, int Lp, const int* meta, int n_e,
                              int maxw, float thr, int* counts,
                              void* stream) {
  if (n_e < 1 || n_e > hp::MAX_ENTRIES || maxw < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * hp::tile_rows(maxw) * hp::tile_cols(maxw);
  cudaError_t err = hp::prepare_smem(scan_pass_a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(hp::TILE_X, hp::TILE_D);
  const dim3 grid((Lp + hp::TILE_X - 1) / hp::TILE_X,
                  (num_p + hp::TILE_D - 1) / hp::TILE_D);
  scan_pass_a_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      raw, cand, num_p, Lp, meta, n_e, maxw, thr, counts);
  return (int)cudaGetLastError();
}
