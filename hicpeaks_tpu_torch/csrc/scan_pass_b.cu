// Pass B of the ring scan: capture of the frozen background sums.
//
// Replaces hicpeaks_tpu/ops/pallas_scan.py::scan_pass_b_pallas.  It replays
// the pool plan over three bands (raw for the Reads freeze test, the
// balanced band `cband` and the expected band `eband` for the
// backgrounds), gated by the `allowed` entry vector that the freeze
// emulation derived from pass A.  At the entry where a candidate pixel
// freezes for p it stores that pixel's donut (KS, KE) and lower-left
// (YS, YE) sums into out[p_idx][0..3].
//
// Exactness.  The result must be bit-identical to the PyTorch twin, which
// keeps the JAX scan's order.  Each thread therefore replays that order
// itself (scan_common.cuh): left-folded line accumulators, rings added as
// ((A + B) + C) + D, entries applying Kc, Ke, Qc, Qe per ring and then the
// Reads rings (hicpeaks_tpu/ops/scan.py:196-215).  Outputs are written once,
// at the capture, into a zero-filled buffer: a pixel never re-captures
// for the same p, as in the twin's `where(do_cap, v, old)`.
//
// Design.  One thread per pixel and a zero-filled halo tile of each band
// in shared memory (2*maxw rows and maxw columns each side).  Every ring
// is recomputed from the tile, which costs O(maxw^2) adds per pixel (about
// 1.2k shared-memory reads at maxw = 10) but keeps no state across threads.
// Threads of non-candidate pixels only help load the tiles.
//
// What bounds it on an H100: those shared-memory reads; the device-memory
// traffic is three tile loads (with halos) per block and one write per
// capture.  Reusing line accumulators across a block's pixels and TMA tile
// loads are later work.
#include "scan_common.cuh"

namespace {

__global__ void scan_pass_b_kernel(const float* __restrict__ raw,
                                   const float* __restrict__ cband,
                                   const float* __restrict__ eband,
                                   const uint8_t* __restrict__ cand,
                                   const uint8_t* __restrict__ allowed,
                                   int num_p, int Lp,
                                   const int* __restrict__ meta, int n_e,
                                   int maxw, float thr,
                                   float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tile = hp::tile_rows(maxw) * hp::tile_cols(maxw);
  float* s_raw = smem;
  float* s_c = smem + tile;
  float* s_e = smem + 2 * tile;

  const int d0 = blockIdx.y * hp::TILE_D;
  const int x0 = blockIdx.x * hp::TILE_X;
  hp::load_tile(s_raw, raw, num_p, Lp, d0, x0, maxw);
  hp::load_tile(s_c, cband, num_p, Lp, d0, x0, maxw);
  hp::load_tile(s_e, eband, num_p, Lp, d0, x0, maxw);
  __syncthreads();

  const int d = d0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  if (d >= num_p || x >= Lp || !cand[(size_t)d * Lp + x]) return;

  const int tw = hp::tile_cols(maxw);
  const hp::Tile Tm{s_raw, tw}, Tc{s_c, tw}, Te{s_e, tw};
  const hp::Plan plan{meta, n_e};
  const int pr = threadIdx.y + 2 * maxw;
  const int pc = threadIdx.x + maxw;
  const size_t plane = (size_t)num_p * Lp;
  const size_t px = (size_t)d * Lp + x;

  float accKc = 0.f, accKe = 0.f, accQc = 0.f, accQe = 0.f, accR = 0.f;
  unsigned captured = 0u;
  for (int e = 0; e < n_e; ++e) {
    const int boff = plan.bg_off(e);
    for (int k = 0; k < plan.bg_len(e); ++k) {
      const int r = plan.ring(boff + k);
      const float kc = Tc.ringK(pr, pc, r);
      const float ke = Te.ringK(pr, pc, r);
      const float qc = Tc.ringQ(pr, pc, r);
      const float qe = Te.ringQ(pr, pc, r);
      accKc = accKc + kc;
      accKe = accKe + ke;
      accQc = accQc + qc;
      accQe = accQe + qe;
    }
    const int roff = plan.rd_off(e);
    for (int k = 0; k < plan.rd_len(e); ++k)
      accR = accR + Tm.ringQ(pr, pc, plan.ring(roff + k));

    const int pi = plan.p_idx(e);
    const unsigned bit = 1u << pi;
    if (!(captured & bit) && accR >= thr && allowed[e]) {
      captured |= bit;
      float* o = out + (size_t)pi * 4 * plane + px;
      o[0] = accKc;
      o[plane] = accKe;
      o[2 * plane] = accQc;
      o[3 * plane] = accQe;
    }
  }
}

}  // namespace

extern "C" int hp_scan_pass_b(const float* raw, const float* cband,
                              const float* eband, const uint8_t* cand,
                              const uint8_t* allowed, int num_p, int Lp,
                              const int* meta, int n_e, int n_p, int maxw,
                              float thr, float* out, void* stream) {
  if (n_e < 1 || n_e > hp::MAX_ENTRIES || n_p < 1 || n_p > 32 || maxw < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      3 * sizeof(float) * hp::tile_rows(maxw) * hp::tile_cols(maxw);
  cudaError_t err = hp::prepare_smem(scan_pass_b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(hp::TILE_X, hp::TILE_D);
  const dim3 grid((Lp + hp::TILE_X - 1) / hp::TILE_X,
                  (num_p + hp::TILE_D - 1) / hp::TILE_D);
  scan_pass_b_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      raw, cband, eband, cand, allowed, num_p, Lp, meta, n_e, maxw, thr,
      out);
  return (int)cudaGetLastError();
}
