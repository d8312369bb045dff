// Pass A of the ring scan: freeze counts.
//
// Replaces hicpeaks_tpu/ops/pallas_scan.py::scan_pass_a_pallas.  For every
// pool-plan entry it counts the candidate pixels whose lower-left "Reads"
// sum of the raw band first reaches `thr` at that entry for that entry's
// p (hicpeaks_tpu/ops/scan.py::_scan_core without captures).
//
// Design.  The same radius-order replay as pass B (scan_common.cuh) over
// the raw band alone: one 32x32-pixel tile per block of 256 threads (4
// pixels a thread).  Per radius the block advances Vn to r and Wq to
// r - 1, waits, and each pixel forms its Reads ring from two plane values;
// then the program's adds and capture tests run in plan order.  The Reads
// sum and one captured bit per p live in registers.  Per-entry counts are
// reduced with a warp ballot into shared memory, then added to the int32
// [n_entries] output with one atomicAdd per block and entry (integer
// counts, exact in any order).  Blocks with no candidate pixel return at
// once.
//
// What bounds it.  The device-memory floor at chr1 scale ([1016, 28672],
// m = 10) is 5 B/pixel in (f32 raw, bool candidate mask), 146 MB:
// 0.044 ms at 3.35 TB/s.  The kernel is bound by shared memory and its
// latency: per radius a block moves about 45 KB through it (12 B per Vn
// and per Wq cell, (32+m)^2 and 32(32+m) of them, and 8 B of ring reads a
// pixel), 0.44 ms at 128 B per clock on 132 SMs; it ran at about 1.05 ms
// on an H100 (PERF.md), with two barriers a radius.  Recomputing each fold per
// pixel from the tile instead reads O(maxw) values per ring (1.48 ms).
//
// Shared memory: 4*((32+2m)(32+2m) + (32+m)^2 + 32(32+m)) bytes plus the
// 2.5 KB program, 28 KB at m = 10; the launch bounds keep four 256-thread
// blocks on an SM (at most 64 registers a thread).
#include "scan_common.cuh"

namespace {

using hp::TILE_D;
using hp::TILE_X;
constexpr int ROWS = 8;               // thread rows: 256 threads a block
constexpr int PX = TILE_D / ROWS;     // pixels a thread: rows ty + j*ROWS
constexpr int THREADS = TILE_X * ROWS;

__global__ void __launch_bounds__(THREADS, 4)
scan_pass_a_kernel(const float* __restrict__ raw,
                   const uint8_t* __restrict__ cand, int num_p, int Lp,
                   const int* __restrict__ meta, int n_meta, float thr,
                   int* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ int s_meta[hp::MAX_META];
  __shared__ int s_counts[hp::MAX_ENTRIES];

  hp::stage(s_meta, meta, n_meta);
  const int n_e = meta[0];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_X + tx;
  for (int k = tid; k < n_e; k += THREADS) s_counts[k] = 0;
  const int d0 = blockIdx.y * TILE_D;
  const int x0 = blockIdx.x * TILE_X;
  bool act[PX];
  bool any = false;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int d = d0 + ty + j * ROWS, x = x0 + tx;
    act[j] = d < num_p && x < Lp && cand[(size_t)d * Lp + x];
    any |= act[j];
  }
  if (!__syncthreads_or(any)) return;

  const hp::Program prog(s_meta);
  const hp::Geom g(prog.maxw);
  const int m = g.m, TC = g.TC, NC = g.NC;
  const hp::Div div_nc(NC);
  const int raw_rows = TILE_D + 2 * m;   // all the Reads planes reach
  float* Tm = smem;
  float* Vnm = Tm + raw_rows * TC;
  float* Wqm = Vnm + g.vn();
  hp::load_tile(Tm, raw, num_p, Lp, d0, x0, g, raw_rows);
  hp::zero(Vnm, g.vn() + g.wq());
  hp::cp_async_wait();

  float aR[PX], qm[PX], sR[PX][hp::MAX_RD_SLOTS];
  unsigned captured[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    aR[j] = qm[j] = 0.f;
    captured[j] = 0u;
  }
  int rend = 0;
  for (int e = 0; e < n_e; ++e) rend = max(rend, prog.cap_step(e));
  for (int r = 0; r <= rend; ++r) {
    if (r > 0) {
      __syncthreads();   // the previous ring reads (or the staging) are done
      // Vn to radius r, Wq to radius r - 1
      for (int k = tid; k < g.vn(); k += THREADS) {
        const int nr = div_nc(k), nc = k - nr * NC;
        Vnm[k] = Vnm[k] + Tm[(nr + m - r) * TC + m + nc];
      }
      if (r > 1) {
        for (int nr = ty; nr < g.NR; nr += ROWS) {
          const int i = nr * TILE_X + tx;
          Wqm[i] = Wqm[i] + Tm[(nr + m - r + 1) * TC + tx + m + r - 1];
        }
      }
      __syncthreads();
      const int need = prog.need(r), rs = prog.rd_slot(r);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        if (need & 2) {
          const int up = ty + j * ROWS + m - r;
          qm[j] = Vnm[up * NC + tx + r] + Wqm[up * TILE_X + tx];
        }
        if (rs >= 0) {   // uniform: the block's program
#pragma unroll
          for (int s = 0; s < hp::MAX_RD_SLOTS; ++s)
            if (s == rs) sR[j][s] = qm[j];
        }
      }
    }
    for (int k = prog.step_off(r); k < prog.step_off(r + 1); ++k) {
      const int op = prog.op(k), kind = op & 3, arg = op >> 2;
      if (kind == hp::OP_RD) {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          float a = qm[j];
          if (arg > 0) {
#pragma unroll
            for (int s = 0; s < hp::MAX_RD_SLOTS; ++s)
              if (s + 1 == arg) a = sR[j][s];
          }
          aR[j] = aR[j] + a;
        }
      } else if (kind == hp::OP_CAP) {
        const unsigned bit = 1u << prog.p_idx(arg);
        int n_new = 0;
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const bool newly = act[j] && !(captured[j] & bit) && aR[j] >= thr;
          if (newly) captured[j] |= bit;   // pass A: every entry is allowed
          // blockDim.x == 32: each warp is one pixel row, all lanes here
          n_new += __popc(__ballot_sync(0xffffffffu, newly));
        }
        if (tx == 0 && n_new) atomicAdd(&s_counts[arg], n_new);
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < n_e; k += THREADS)
    if (s_counts[k]) atomicAdd(&counts[k], s_counts[k]);
}

// Dynamic shared memory of one block (ops/cuda_scan.py smem_bytes adds
// the static part).
size_t smem_bytes(int maxw) {
  const hp::Geom g(maxw);
  return sizeof(float) * ((size_t)(TILE_D + 2 * maxw) * g.TC +
                          (size_t)g.vn() + (size_t)g.wq());
}

}  // namespace

extern "C" int hp_scan_pass_a(const float* raw, const uint8_t* cand,
                              int num_p, int Lp, const int* meta, int n_meta,
                              int n_e, int maxw, float thr, int* counts,
                              void* stream) {
  if (n_e < 1 || n_e > hp::MAX_ENTRIES || maxw < 1 || n_meta < 1 ||
      n_meta > hp::MAX_META || num_p < 1 || Lp < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(maxw);
  cudaError_t err = hp::prepare_smem(scan_pass_a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TILE_X, ROWS);
  const dim3 grid((Lp + TILE_X - 1) / TILE_X, (num_p + TILE_D - 1) / TILE_D);
  scan_pass_a_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      raw, cand, num_p, Lp, meta, n_meta, thr, counts);
  return (int)cudaGetLastError();
}
