// The dense float32 stages of the batched pyHICCUPS scorer, fused.
//
// core/engine._compact_batched scores B backgrounds (each (pw, ww) pair's
// donut 'K' and lower-left 'Y') of one chromosome's band [num_p, Lp].  Its
// eager form (ops/score: expected_observed, lambda_chunks, chunk_pack,
// chunk_keep, lambda_suspects) runs dozens of full-size torch ops over
// [B, num_p, Lp] stacks.  No TPU kernel computes these stages: the JAX
// package leaves them to XLA's fusion.  Here they are three kernels:
//
// - score_observe_kernel: one pass over the band's pixels for all B
//   backgrounds.  A thread owns a pixel (d, x) and loops over b, so the
//   band, the candidate mask, Bprod, IR[d] and the band edge are read once
//   for all B, and each background's pass-B capture planes (SV, EV) are
//   read in place through a pointer table (no [B, num_p, Lp] stack).  It
//   writes the histogram's inputs (the shared count clamp(floor(O), 0,
//   C - 1) and each background's chunk id, 0 where not valid) and one
//   flag byte a background (scored, valid, lambda-chunk edge suspect).
// - score_keep_kernel: after the histogram and its thresholds, the keep
//   mask (histogram BH, the gap filter, and in exact mode the suspects set
//   aside) and the suspect mask, from the flags, the chunk ids, the band
//   and the thresholds.
// - score_gather_kernel: the few values the compaction's pixels need (O,
//   ICE, Fold and chunk of the kept pixels; chunk, count and gap flag of
//   the suspects; prod at the postcheck's pixels), recomputed there from
//   the same planes in the same order instead of being written densely.
//
// Every value is the eager chain's bit for bit.  The library is built with
// --fmad=false and without fast math: each product and sum rounds on its
// own, the division is IEEE's, and logf is the CUDA math library's, as in
// torch's own kernels.  The chunk edges 2^((c-2)/3) and 2^((c-1)/3) come
// from a table that ops/cuda_score.py computes on the device with the very
// torch ops lambda_chunks runs, indexed by chunk id.
//
// Bound: bytes.  At chr1 (num_p 1016, Lp 24,960, n = 25.4M pixels) and
// B = 6 the observe kernel moves at most about 91 bytes a pixel (2.3 GB)
// and the keep kernel about 47 (1.2 GB): about 1.05 ms at 3.35 TB/s, where
// the eager chain spent some 30 ms.  The observe kernel reads a
// background's planes only where it may score a pixel (a candidate, at or
// beyond its radius, EV != 0 for SV), so the sectors of the band that
// hold no candidate, most of its far diagonals, are never read; its log
// and quotients run only there too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // pixel columns a block takes in a row
constexpr int kMaxB = 64;          // backgrounds, mirrored in cuda_score.py
constexpr int kEdges = 512;        // chunk ids of the edge table

// flag bits of a (background, pixel)
constexpr unsigned char kScored = 1, kValid = 2, kSuspect = 4;

// Each background's capture planes [num_p, Lp] (pass B's SV and EV) and
// window radius, passed by value.
struct Planes {
  const float* sv[kMaxB];
  const float* ev[kMaxB];
  int wi[kMaxB];
  int B;
};

// The chromosome's shared sheets.
struct Sheets {
  const float* raw;            // [num_p, Lp]
  const float* bprod;          // [num_p, Lp]
  const unsigned char* cand;   // bool [num_p, Lp]
  const float* ir;             // [num_p]
  long long num_p, Lp, L;
};

// One background's numbers at one pixel.
struct Chain {
  float prod, E, t;
  int cid;
  bool scored, valid;
};

// ops/score.expected_observed and lambda_chunks at one (b, d, x), in their
// float32 order.  `live`: d >= wi[b] and the pixel is a candidate; `em`:
// IR[d] inside the band, else 0; lv/rv: the edge table.  A pixel that is
// not scored has safeE = 1, so t = 0 and its chunk 1, not valid: those
// are set without the log.
__device__ __forceinline__ Chain chain(float sv, float ev, bool live,
                                       float em, float bprod,
                                       const float* lv, const float* rv,
                                       float ln2) {
  Chain c;
  const bool mask = ev != 0.0f && live;
  const float ratio = mask ? sv / ev : 0.0f;
  c.prod = em * ratio;
  c.E = c.prod * bprod;
  c.scored = c.prod != 0.0f && c.E > 0.0f;
  if (!c.scored) {
    c.t = 0.0f;
    c.cid = 1;
    c.valid = false;
    return c;
  }
  const float safe = c.E;
  c.t = 3.0f * (logf(safe) / ln2);
  // floor(t).to(int32) + 2, then clamp(min=1); t = +inf saturates and wraps
  // as torch's int32 add does
  int cid = (int)((unsigned)__float2int_rz(floorf(c.t)) + 2u);
  cid = cid < 1 ? 1 : cid;
  cid = cid < kEdges - 1 ? cid : kEdges - 2;   // finite t stays below 390
  cid = (safe <= lv[cid] && cid > 1) ? cid - 1
                                     : (safe >= rv[cid] ? cid + 1 : cid);
  c.valid = c.scored && safe > lv[cid] && safe < rv[cid];
  c.cid = cid;
  return c;
}

// clamp(floor(o), 0, hi) as torch.clamp keeps it: NaN stays NaN.
__device__ __forceinline__ float count_of(float o, float hi) {
  const float f = floorf(o);
  return f != f ? f : fminf(fmaxf(f, 0.0f), hi);
}

__global__ void __launch_bounds__(kThreads) score_observe_kernel(
    Sheets sh, const __grid_constant__ Planes pl, const float* edges,
    float ln2, float margin, int S, int C, int* __restrict__ oc,
    int* __restrict__ cid0, unsigned char* __restrict__ flags) {
  __shared__ float lv[kEdges], rv[kEdges];
  for (int i = threadIdx.x; i < kEdges; i += kThreads) {
    lv[i] = edges[i];
    rv[i] = edges[kEdges + i];
  }
  __syncthreads();
  const long long n = sh.num_p * sh.Lp;
  const long long nxb = (sh.Lp + kThreads - 1) / kThreads;
  const float hi = (float)(C - 1);
  for (long long j = blockIdx.x; j < sh.num_p * nxb; j += gridDim.x) {
    const long long d = j / nxb;
    const long long x = (j - d * nxb) * kThreads + threadIdx.x;
    if (x >= sh.Lp) continue;
    const long long i = d * sh.Lp + x;
    oc[i] = __float2int_rz(count_of(__ldg(sh.raw + i), hi));
    // a pixel no background scores (not a candidate; for a background, a
    // row below its radius or EV = 0) reads none of its planes' values:
    // where a whole warp's pixels are such, their sectors stay unread
    if (!__ldg(sh.cand + i)) {
      for (int b = 0; b < pl.B; ++b) {
        cid0[b * n + i] = 0;
        flags[b * n + i] = 0;
      }
      continue;
    }
    const float em = x < sh.L - d ? __ldg(sh.ir + d) : 0.0f;
    const float bp = __ldg(sh.bprod + i);
#pragma unroll 2
    for (int b = 0; b < pl.B; ++b) {
      const bool live = d >= pl.wi[b];
      const float ev = live ? __ldg(pl.ev[b] + i) : 0.0f;
      const float sv = ev != 0.0f ? __ldg(pl.sv[b] + i) : 0.0f;
      const Chain c = chain(sv, ev, live, em, bp, lv, rv, ln2);
      const bool sus = c.scored && fabsf(c.t - rintf(c.t)) < margin;
      const long long o = b * n + i;
      cid0[o] = c.valid ? (c.cid < S - 1 ? c.cid : S - 1) : 0;
      flags[o] = (c.scored ? kScored : 0) | (c.valid ? kValid : 0) |
                 (sus ? kSuspect : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads) score_keep_kernel(
    const float* __restrict__ raw, const unsigned char* __restrict__ gap,
    const int* __restrict__ cid0, const unsigned char* __restrict__ flags,
    const float* __restrict__ thr, long long num_p, long long Lp, int B,
    int S, int C, int sig1, int exact, unsigned char* __restrict__ keep,
    unsigned char* __restrict__ sus) {
  const long long n = num_p * Lp;
  const long long nxb = (Lp + kThreads - 1) / kThreads;
  const float hi = (float)(C - 1);
  for (long long j = blockIdx.x; j < num_p * nxb; j += gridDim.x) {
    const long long d = j / nxb;
    const long long x = (j - d * nxb) * kThreads + threadIdx.x;
    if (x >= Lp) continue;
    const long long i = d * Lp + x;
    const float o = count_of(raw[i], hi);
    const bool g = gap[i] != 0;
#pragma unroll 2
    for (int b = 0; b < B; ++b) {
      const long long at = b * n + i;
      const unsigned char f = flags[at];
      // chunk_keep: valid & (count >= thr[b, chunk]), and where not valid
      // the scored pixels when sig >= 1
      bool k = (f & kValid) ? o >= __ldg(thr + (long long)b * S + cid0[at])
                            : ((f & kScored) && sig1);
      k = k && !g;
      if (exact) {
        const bool s = (f & kSuspect) != 0;
        sus[at] = s;
        k = k && !s;
      }
      keep[at] = k;
    }
  }
}

// One pixel set of score_gather_kernel: B rows of K (d, x) slots, and the
// outputs [B, K] to write (null: not wanted).
struct Gathered {
  const int* d;
  const int* x;
  int K;
  float* O;              // the band's count
  float* ice;            // cband
  float* fold;           // O / E where scored, else 0
  int* cid;              // the chunk where valid, else 0
  int* count;            // clamp(floor(O), 0, C - 1)
  unsigned char* gap;    // the gap filter's flag
  float* prod;           // EM * ratio
};

__global__ void __launch_bounds__(kThreads) score_gather_kernel(
    Sheets sh, const float* __restrict__ cband,
    const unsigned char* __restrict__ gapdrop,
    const __grid_constant__ Planes pl, const float* edges, float ln2,
    int C, const __grid_constant__ Gathered g0,
    const __grid_constant__ Gathered g1) {
  const long long n0 = (long long)pl.B * g0.K;
  const long long total = n0 + (long long)pl.B * g1.K;
  const float* lv = edges;
  const float* rv = edges + kEdges;
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const bool first = t < n0;
    const Gathered& g = first ? g0 : g1;   // read in place
    const long long s = first ? t : t - n0;
    const int b = (int)(s / g.K);
    const long long d = g.d[s], x = g.x[s];
    const long long i = d * sh.Lp + x;
    const float raw = sh.raw[i];
    const float em = x < sh.L - d ? sh.ir[d] : 0.0f;
    const Chain c = chain(pl.sv[b][i], pl.ev[b][i],
                          sh.cand[i] != 0 && d >= pl.wi[b], em,
                          sh.bprod[i], lv, rv, ln2);
    if (g.O) g.O[s] = raw;
    if (g.ice) g.ice[s] = cband[i];
    if (g.fold) g.fold[s] = c.scored ? raw / c.E : 0.0f;
    if (g.cid) g.cid[s] = c.valid ? c.cid : 0;
    if (g.count)
      g.count[s] = __float2int_rz(count_of(raw, (float)(C - 1)));
    if (g.gap) g.gap[s] = gapdrop[i];
    if (g.prod) g.prod[s] = c.prod;
  }
}

bool planes_ok(const void* const* sv, const void* const* ev, const int* wi,
               int B, Planes* pl) {
  if (B < 1 || B > kMaxB) return false;
  pl->B = B;
  for (int b = 0; b < B; ++b) {
    pl->sv[b] = (const float*)sv[b];
    pl->ev[b] = (const float*)ev[b];
    pl->wi[b] = wi[b];
  }
  return true;
}

// As many blocks as fit on the card at once, at most one a work item.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long items, int sms, unsigned* grid) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)sms * per_sm;
  g = g < items ? g : items;
  *grid = (unsigned)(g < 1 ? 1 : g);
  return cudaSuccess;
}

}  // namespace

// raw, bprod, ir float32 and cand bool: the band's sheets; sv, ev: host
// arrays of B device pointers to each background's capture planes, wi its
// window radius; edges float32 [2, 512] (left, right edge by chunk id);
// oc int32 [num_p * Lp], cid0 int32 and flags uint8 [B, num_p * Lp].
extern "C" int hp_score_observe(
    const float* raw, const float* bprod, const unsigned char* cand,
    const float* ir, long long num_p, long long Lp, long long L,
    const void* const* sv, const void* const* ev, const int* wi, int B,
    const float* edges, float ln2, float margin, int S, int C, int* oc,
    int* cid0, unsigned char* flags, int sms, void* stream) {
  Planes pl;
  if (!planes_ok(sv, ev, wi, B, &pl) || num_p < 1 || Lp < 1 || S < 2 ||
      C < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const long long items = num_p * ((Lp + kThreads - 1) / kThreads);
  cudaError_t err = grid_for(score_observe_kernel, items, sms, &grid);
  if (err != cudaSuccess) return (int)err;
  score_observe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Sheets{raw, bprod, cand, ir, num_p, Lp, L}, pl, edges, ln2, margin, S,
      C, oc, cid0, flags);
  return (int)cudaGetLastError();
}

// thr float32 [B, S]: the keep thresholds; keep and sus bool [B, num_p *
// Lp] (sus written only in exact mode).
extern "C" int hp_score_keep(
    const float* raw, const unsigned char* gap, const int* cid0,
    const unsigned char* flags, const float* thr, long long num_p,
    long long Lp, int B, int S, int C, int sig1, int exact,
    unsigned char* keep, unsigned char* sus, int sms, void* stream) {
  if (num_p < 1 || Lp < 1 || B < 1 || S < 2 || C < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const long long items = num_p * ((Lp + kThreads - 1) / kThreads);
  cudaError_t err = grid_for(score_keep_kernel, items, sms, &grid);
  if (err != cudaSuccess) return (int)err;
  score_keep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      raw, gap, cid0, flags, thr, num_p, Lp, B, S, C, sig1, exact, keep, sus);
  return (int)cudaGetLastError();
}

// Two pixel sets, each int32 d and x [B, K] with its outputs (see
// Gathered; null where not wanted; K may be 0).
extern "C" int hp_score_gather(
    const float* raw, const float* bprod, const unsigned char* cand,
    const float* ir, const float* cband, const unsigned char* gapdrop,
    long long num_p, long long Lp, long long L, const void* const* sv,
    const void* const* ev, const int* wi, int B, const float* edges,
    float ln2, int C, const int* d0, const int* x0, int K0, float* O0,
    float* ice0, float* fold0, int* cid0, const int* d1, const int* x1,
    int K1, int* cid1, int* count1, unsigned char* gap1, float* prod1,
    int sms, void* stream) {
  Planes pl;
  if (!planes_ok(sv, ev, wi, B, &pl) || num_p < 1 || Lp < 1 || C < 1 ||
      K0 < 0 || K1 < 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * K0 + (long long)B * K1;
  if (total == 0) return (int)cudaSuccess;
  unsigned grid = 0;
  cudaError_t err = grid_for(score_gather_kernel,
                             (total + kThreads - 1) / kThreads, sms, &grid);
  if (err != cudaSuccess) return (int)err;
  score_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Sheets{raw, bprod, cand, ir, num_p, Lp, L}, cband, gapdrop, pl, edges,
      ln2, C,
      Gathered{d0, x0, K0, O0, ice0, fold0, cid0, nullptr, nullptr, nullptr},
      Gathered{d1, x1, K1, nullptr, nullptr, nullptr, cid1, count1, gap1,
               prod1});
  return (int)cudaGetLastError();
}
