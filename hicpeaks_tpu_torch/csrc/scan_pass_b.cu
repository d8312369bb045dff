// Pass B of the ring scan: capture of the frozen background sums.
//
// Replaces hicpeaks_tpu/ops/pallas_scan.py::scan_pass_b_pallas.  It replays
// the pool plan over three bands (raw for the Reads freeze test, the
// balanced band `cband` and the expected band `eband` for the
// backgrounds), gated by the `allowed` entry vector that the freeze
// emulation derived from pass A.  At the entry where a candidate pixel
// freezes for p it stores that pixel's donut (KS, KE) and lower-left
// (YS, YE) sums into out[p_idx][0..3]; every other output cell gets 0, so
// the output needs no zero fill before the launch.
//
// Exactness.  The result must be bit-identical to the PyTorch twin, which
// keeps the JAX scan's order: left-folded line accumulators, rings added
// as ((A + B) + C) + D, entries applying Kc, Ke, Qc, Qe per ring and then
// the Reads rings (hicpeaks_tpu/ops/scan.py:196-215).  The accumulator
// planes advance by the same folds (scan_common.cuh), each pixel's sums
// take the same adds in plan order, and a pixel never re-captures for the
// same p, as in the twin's `where(do_cap, v, old)`.
//
// Design.  One 32x32-pixel tile per block of 512 threads (2 pixels a
// thread).  cband and eband share one float2 halo tile and float2 planes,
// so one shared-memory access serves both; raw keeps its own tile and its
// Vn, Wq planes.  The re-add slots are touched only at the radii whose
// ring a later entry re-adds (uniform branches), so a plan without drift
// re-adds never touches the slot arrays (which ptxas may keep in local
// memory at 64 registers a thread).  Per radius r the block advances the V planes to r and
// the W planes to r - 1 in one pass over flattened plane indices, waits,
// and each pixel reads its 14 ring values: two barriers a radius.  The
// radius loop stops at the last allowed entry's capture, and a block with
// no candidate pixel only writes its zeros.
//
// What bounds it.  The device-memory floor at chr1 scale ([1016, 28672],
// n_p = 1, the pyHICCUPS plan, m = maxw = 10) is 13 B/pixel in and
// 16 B/pixel out, 845 MB: 0.25 ms at 3.35 TB/s.  The kernel is bound by
// shared memory instead: per radius a block moves about 283 KB through it
// (the plane updates over their halo regions, 2.6x the pixels for Vx, and
// 56 B of ring reads a pixel), about 2.8 KB a pixel over the 10 radii, or
// 2.7 ms at 128 B per clock on 132 SMs; it ran at about 4.8 ms on an
// H100 (PERF.md), near 55 % of that rate.  Recomputing every fold per pixel instead
// costs O(maxw^2), about 1.2k shared reads per candidate pixel (8.24 ms).
// The halo tiles read each band about 2.9x from L2 (5.7x with 16x32
// tiles).  Going further needs the planes in registers, which means
// a compile-time maxw.
//
// Shared memory: 4*(2*(32+4m)(32+2m) + (32+2m)^2 + 2*(32+2m)^2
// + 3*(32+m)^2 + 2*32*(32+2m) + 3*32*(32+m)) bytes plus the 2.2 KB
// program, 115 KB at m = 10: two blocks (at most 64 registers a thread)
// fit on an SM up to m = 10, one up to m = 23.  ops/cuda_scan.py refuses a
// larger m.
#include "scan_common.cuh"

namespace {

using hp::TILE_D;
using hp::TILE_X;
constexpr int ROWS = 16;              // thread rows: 512 threads a block
constexpr int PX = TILE_D / ROWS;     // pixels a thread: rows ty + j*ROWS
constexpr int THREADS = TILE_X * ROWS;

__global__ void __launch_bounds__(THREADS, 2)
scan_pass_b_kernel(const float* __restrict__ raw,
                   const float* __restrict__ cband,
                   const float* __restrict__ eband,
                   const uint8_t* __restrict__ cand,
                   const uint8_t* __restrict__ allowed, int num_p, int Lp,
                   const int* __restrict__ meta, int n_meta, int n_p,
                   float thr, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int s_meta[hp::MAX_META];
  __shared__ uint8_t s_allowed[hp::MAX_ENTRIES];
  __shared__ int s_rend;

  hp::stage(s_meta, meta, n_meta);
  const int n_e = meta[0];
  hp::stage(s_allowed, allowed, n_e);
  __syncthreads();
  const hp::Program prog(s_meta);
  const hp::Geom g(prog.maxw);
  const int m = g.m, TC = g.TC, NC = g.NC;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  const hp::Div div_tc(TC);
  if (tid == 0) {
    int rend = -1;   // the last step whose ops can reach an output
    for (int e = 0; e < n_e; ++e)
      if (s_allowed[e] && prog.cap_step(e) > rend) rend = prog.cap_step(e);
    s_rend = rend;
  }

  const int d0 = blockIdx.y * TILE_D;
  const int x0 = blockIdx.x * TILE_X;
  const size_t plane = (size_t)num_p * Lp;
  bool valid[PX], act[PX];
  size_t px[PX];
  bool any = false;
  unsigned captured[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int d = d0 + ty + j * ROWS, x = x0 + tx;
    valid[j] = d < num_p && x < Lp;
    px[j] = valid[j] ? (size_t)d * Lp + x : 0;
    act[j] = valid[j] && cand[px[j]];
    any |= act[j];
    captured[j] = 0u;
  }

  if (__syncthreads_or(any) && s_rend >= 0) {
    // cband and eband interleaved (.x, .y): one access serves both
    const int raw_rows = TILE_D + 2 * m;   // all the Reads planes reach
    float2* T2 = reinterpret_cast<float2*>(smem);
    float2* Vx2 = T2 + g.tile();
    float2* Vn2 = Vx2 + g.vx();
    float2* Wx2 = Vn2 + g.vn();
    float2* Wq2 = Wx2 + g.wx();
    float* Tm = reinterpret_cast<float*>(Wq2 + g.wq());
    float* Vnm = Tm + raw_rows * TC;
    float* Wqm = Vnm + g.vn();
    hp::load_tile2(T2, cband, eband, num_p, Lp, d0, x0, g);
    hp::load_tile(Tm, raw, num_p, Lp, d0, x0, g, raw_rows);
    hp::zero(reinterpret_cast<float*>(Vx2),
             2 * (g.vx() + g.vn() + g.wx() + g.wq()));
    hp::zero(Vnm, g.vn() + g.wq());
    hp::cp_async_wait();

    float aKc[PX], aKe[PX], aQc[PX], aQe[PX], aR[PX];
    float kc[PX], ke[PX], qc[PX], qe[PX], qm[PX];
    float sKc[PX][hp::MAX_BG_SLOTS], sKe[PX][hp::MAX_BG_SLOTS],
        sQc[PX][hp::MAX_BG_SLOTS], sQe[PX][hp::MAX_BG_SLOTS],
        sR[PX][hp::MAX_RD_SLOTS];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      aKc[j] = aKe[j] = aQc[j] = aQe[j] = aR[j] = 0.f;
      kc[j] = ke[j] = qc[j] = qe[j] = qm[j] = 0.f;
    }
    const int rend = s_rend;
    for (int r = 0; r <= rend; ++r) {
      if (r > 0) {
        // the previous step's ring reads (or the staging) are done
        __syncthreads();
        // V planes to radius r ...
        for (int i = tid; i < g.vx(); i += THREADS) {
          const int vr = div_tc(i), vc = i - vr * TC;
          // Vx cell i sits on tile cell i + m*TC; its band reads are r
          // rows above and below
          const int lo = i + (m - r) * TC, hi = i + (m + r) * TC;
          const float2 l = T2[lo], h = T2[hi];
          float2 v = Vx2[i];
          v.x = (v.x + h.x) + l.x;
          v.y = (v.y + h.y) + l.y;
          Vx2[i] = v;
          if (vr < g.NR && vc >= m) {
            const int k = vr * NC + (vc - m);
            float2 n = Vn2[k];
            n.x = n.x + l.x;
            n.y = n.y + l.y;
            Vn2[k] = n;
            Vnm[k] = Vnm[k] + Tm[lo];
          }
        }
        // ... and W planes to radius r - 1: ring r reads V_r and W_{r-1}
        if (r > 1) {
          const int w = r - 1;
          for (int wr = ty; wr < g.VR; wr += ROWS) {
            const int a = (wr + m - w) * TC + tx + m + w;
            const int b = (wr + m + w) * TC + tx + m - w;
            const int i = wr * TILE_X + tx;
            const float2 ta = T2[a], tb = T2[b];
            float2 v = Wx2[i];
            v.x = (v.x + ta.x) + tb.x;
            v.y = (v.y + ta.y) + tb.y;
            Wx2[i] = v;
            if (wr < g.NR) {
              float2 q = Wq2[i];
              q.x = q.x + ta.x;
              q.y = q.y + ta.y;
              Wq2[i] = q;
              Wqm[i] = Wqm[i] + Tm[a];
            }
          }
        }
        __syncthreads();
        // this thread's pixels' ring values of radius r
        const int need = prog.need(r);
        const int bs = prog.bg_slot(r), rs = prog.rd_slot(r);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const int up = ty + j * ROWS + m - r, dn = up + 2 * r;
          if (need & 1) {
            const int vA = up * TC + tx + m + r, vB = dn * TC + tx + m - r;
            const int wC = dn * TILE_X + tx, wD = up * TILE_X + tx;
            const int nA = up * NC + tx + r;
            const float2 A = Vx2[vA], B = Vx2[vB], C = Wx2[wC], D = Wx2[wD];
            const float2 N = Vn2[nA], Q = Wq2[wD];
            kc[j] = ((A.x + B.x) + C.x) + D.x;
            ke[j] = ((A.y + B.y) + C.y) + D.y;
            qc[j] = N.x + Q.x;
            qe[j] = N.y + Q.y;
          }
          if (need & 2)
            qm[j] = Vnm[up * NC + tx + r] + Wqm[up * TILE_X + tx];
          // keep the rings that a later entry re-adds (bs and rs are the
          // block's, so these branches are uniform)
          if (bs >= 0) {
#pragma unroll
            for (int s = 0; s < hp::MAX_BG_SLOTS; ++s)
              if (s == bs) {
                sKc[j][s] = kc[j];
                sKe[j][s] = ke[j];
                sQc[j][s] = qc[j];
                sQe[j][s] = qe[j];
              }
          }
          if (rs >= 0) {
#pragma unroll
            for (int s = 0; s < hp::MAX_RD_SLOTS; ++s)
              if (s == rs) sR[j][s] = qm[j];
          }
        }
      }
      // the plan's adds and captures scheduled at step r, in plan order
      for (int k = prog.step_off(r); k < prog.step_off(r + 1); ++k) {
        const int op = prog.op(k), kind = op & 3, arg = op >> 2;
        if (kind == hp::OP_BG) {
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            float a = kc[j], b = ke[j], c = qc[j], d = qe[j];
            if (arg > 0) {
#pragma unroll
              for (int s = 0; s < hp::MAX_BG_SLOTS; ++s)
                if (s + 1 == arg) {
                  a = sKc[j][s];
                  b = sKe[j][s];
                  c = sQc[j][s];
                  d = sQe[j][s];
                }
            }
            aKc[j] = aKc[j] + a;
            aKe[j] = aKe[j] + b;
            aQc[j] = aQc[j] + c;
            aQe[j] = aQe[j] + d;
          }
        } else if (kind == hp::OP_RD) {
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
        } else if (s_allowed[arg]) {
          const int pi = prog.p_idx(arg);
          const unsigned bit = 1u << pi;
#pragma unroll
          for (int j = 0; j < PX; ++j)
            if (act[j] && !(captured[j] & bit) && aR[j] >= thr) {
              captured[j] |= bit;
              float* o = out + (size_t)pi * 4 * plane + px[j];
              o[0] = aKc[j];
              o[plane] = aKe[j];
              o[2 * plane] = aQc[j];
              o[3 * plane] = aQe[j];
            }
        }
      }
    }
  }

  // every output cell not captured above is 0
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (!valid[j]) continue;
    for (int p = 0; p < n_p; ++p) {
      if (captured[j] & (1u << p)) continue;
      float* o = out + (size_t)p * 4 * plane + px[j];
      o[0] = 0.f;
      o[plane] = 0.f;
      o[2 * plane] = 0.f;
      o[3 * plane] = 0.f;
    }
  }
}

// Dynamic shared memory of one block (ops/cuda_scan.py smem_bytes adds
// the static part).
size_t smem_bytes(int maxw) {
  const hp::Geom g(maxw);
  return sizeof(float) *
         (2 * (size_t)g.tile() + (size_t)(TILE_D + 2 * maxw) * g.TC +
          2 * (size_t)g.vx() + 3 * (size_t)g.vn() + 2 * (size_t)g.wx() +
          3 * (size_t)g.wq());
}

}  // namespace

extern "C" int hp_scan_pass_b(const float* raw, const float* cband,
                              const float* eband, const uint8_t* cand,
                              const uint8_t* allowed, int num_p, int Lp,
                              const int* meta, int n_meta, int n_e, int n_p,
                              int maxw, float thr, float* out, void* stream) {
  if (n_e < 1 || n_e > hp::MAX_ENTRIES || n_p < 1 || n_p > hp::MAX_P ||
      maxw < 1 || n_meta < 1 || n_meta > hp::MAX_META || num_p < 1 || Lp < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(maxw);
  cudaError_t err = hp::prepare_smem(scan_pass_b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TILE_X, ROWS);
  const dim3 grid((Lp + TILE_X - 1) / TILE_X, (num_p + TILE_D - 1) / TILE_D);
  scan_pass_b_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      raw, cband, eband, cand, allowed, num_p, Lp, meta, n_meta, n_p, thr,
      out);
  return (int)cudaGetLastError();
}
