// Float64 window statistics of pyHICCUPS's compacted pixels, on the card
// that holds the band.
//
// The fused scorer keeps, for each background b, a float32 superset of its
// significant pixels and sets aside the lambda-chunk edge suspects, both
// compacted in row-major order (core/engine._keep_batched).  Completing
// them needs each pixel's float64 statistics, which the host computed
// from its copy of the band (ops/hostexact.exact_stats over the native
// walk of csrc/host/bandbuild.cpp ring_sums).  This kernel computes the
// same numbers, bit for bit, from the band already on the card, for every
// background and both pixel sets in one launch:
//
// - the window walk: the five ring families of ring_sums, of which a
//   background reads three (the quadrant raw rings that drive the freeze,
//   and its own balanced and expected rings: non-cross cells for the donut
//   'K', quadrant cells for the lower-left 'Y').  Each ring's sum adds its
//   cells in ring_sums' order (a outer, b inner), so the walk goes radius
//   by radius and visits a ring's cells in that order.  Same clip of the
//   balanced cell's column (tp + dp, at Lp - 1), same ww_min and extent
//   rules, and the zeros of the cells outside the band are added too;
// - hostexact.freeze_entries and background_sums over the pool plan, in
//   plan order;
// - O = raw, ICE = O * (w[x] * w[x+d]), E = ((IR[d] * ratio) * b[x]) *
//   b[x+d], Fold = O / E, in hostexact.exact_stats' order;
// - the lambda chunk of hostexact.chunk_ids64, clipped to [0, S - 1], 0 for
//   no chunk.  It is decided by comparisons against numpy's own edges
//   2^((k-2)/3), made on the host (ops/cuda_complete.chunk_edges64), not by
//   the card's log2 or pow: chunk k is the open interval between edges k
//   and k + 1, chunk 1 is (0, 1), and E on an edge is in no chunk.
//
// A pixel leaves as its (chunk, count) cell, chunk * C + count with the
// kept pixel's count clamp(floor(O), 0, C - 1) and the suspect's the
// device's own, or -1 for a slot past its set's count.
//
// A second kernel, finish64_kernel, completes the tables and the rows, as
// core/hostcomplete._compact_to_host does on the host, one block a
// (chunk, background) row of the histogram:
// - the row's copy takes each suspect out of its device cell and into its
//   float64 one (integer moves, exact in any order);
// - m and rank_max (a suffix sum, right to left) in int64, then qraw =
//   min(ptab * m / max(rank_max, 1), 1) where rank_max > 0, else 2, and
//   the prefix minimum over ascending counts: host_chunk_qtab64's
//   operations, each rounded as numpy rounds it;
// - the audit: cells of the row with q <= sig below the device's count
//   threshold that hold a pixel other than a suspect, counted a
//   background (row 0, the trash row, excluded);
// - every pixel slot whose cell lies in the row: its p and q by lookup (1
//   outside any chunk), and whether it is kept (q <= sig, and for a
//   suspect outside the gap filter), with its row of the output.
// Where the card is busy the row's work is small (C = 1025 at the chr1
// band's counts); the kernel's cost is its launch.
//
// The library is built with --fmad=false, so no product is fused into a
// sum, and a float64 division on the card is IEEE's: every number is the
// host's.  One thread a pixel slot; the sets' counts are read from device
// memory, so sizing the launch needs no read.  Slots past a set's count
// get zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxW = 64;           // ring_sums' own limit

// Plan layout (ops/cuda_complete.py plan_meta), int32 words: B pairs
// (p, kind) with kind 0 = 'K' and 1 = 'Y', then per pool entry in plan
// order [p, index, n_reads, n_bg, reads rings..., bg rings...].
struct Plan {
  const int* words;
  int n_e, B;
};

// The pixel set one slot falls in: its count and its (d, x) rows.
struct Set {
  const int* cnt;             // [B]
  const int* d;               // [B, K]
  const int* x;               // [B, K]
  int K;
};

constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of v over the block's threads in thread order under op
// (sum or minimum, exact in any order); *total gets the block's whole
// scan.  Every thread of the block calls it.
template <typename T, typename Op>
__device__ T block_scan(T v, T identity, Op op, T* total) {
  __shared__ T warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = op(n, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? warp_tot[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op(n, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = op(warp_tot[warp - 1], v);
  *total = warp_tot[n_warps - 1];
  __syncthreads();
  return v;
}

struct Add {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct Min {
  __device__ double operator()(double a, double b) const {
    return fmin(a, b);
  }
};

__device__ __forceinline__ int chunk_of(double E, const double* edges,
                                        int n_edges, int S) {
  if (!(E > 0.0)) return 0;
  int lo = 0, hi = n_edges;   // lo = the number of edges below E
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] < E) lo = mid + 1;
    else hi = mid;
  }
  if (lo < n_edges && edges[lo] == E) return 0;
  return min(1 + lo, S - 1);
}

__global__ void __launch_bounds__(kThreads) complete64_kernel(
    const float* __restrict__ raw, long long num_p, long long Lp,
    long long L, long long ww_min, int maxw,
    const double* __restrict__ w64, const double* __restrict__ b64,
    const double* __restrict__ ir64, const double* __restrict__ allowed,
    Plan plan, Set kept, Set sus, const int* __restrict__ O_s, double thr,
    const double* __restrict__ edges, int n_edges, int S, int C,
    double* __restrict__ stats, int* __restrict__ cell) {
  const int N = kept.K + sus.K;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)plan.B * N) return;
  const int b = (int)(t / N), j = (int)(t % N);
  const Set& s = j < kept.K ? kept : sus;
  const int k = j < kept.K ? j : j - kept.K;
  const long long BN = (long long)plan.B * N;
  if (k >= s.cnt[b]) {
    for (int f = 0; f < 4; ++f) stats[f * BN + t] = 0.0;
    cell[t] = -1;
    return;
  }
  const long long d = s.d[(long long)b * s.K + k];
  const long long x = s.x[(long long)b * s.K + k];
  const int p = plan.words[2 * b];
  const bool quad = plan.words[2 * b + 1] != 0;   // 'Y'

  // ring sums: Qm (quadrant raw), and the background's balanced (sv) and
  // expected (ev) rings
  double Qm[kMaxW + 1], Sv[kMaxW + 1], Ev[kMaxW + 1];
  Qm[0] = Sv[0] = Ev[0] = 0.0;
  for (int r = 1; r <= maxw; ++r) {
    double qm = 0.0, sv = 0.0, ev = 0.0;
    for (int a = -r; a <= r; ++a) {
      // ring r's cells of column offset a, b ascending: all of them on
      // the ring's two outer columns, else the two ends
      const bool edge = a == -r || a == r;
      const int step = edge ? 1 : 2 * r;
      for (int bb = -r; bb <= r; bb += step) {
        const bool is_k = a != 0 && bb != 0;
        const bool is_q = a >= 1 && bb <= -1;
        if (!(quad ? is_q : is_k)) continue;   // is_q implies is_k
        const long long dp = d + bb - a, tp = x + a;
        double rawv = 0.0, cv = 0.0, e = 0.0;
        if (dp >= 0 && dp < num_p && tp >= 0 && tp < Lp) {
          rawv = (double)raw[dp * Lp + tp];
          if (dp >= ww_min) {
            const long long yc = tp + dp > Lp - 1 ? Lp - 1 : tp + dp;
            cv = rawv * w64[tp] * w64[yc];
          }
          if (tp < L - dp) e = ir64[dp];
        }
        if (is_q) qm += rawv;
        sv += cv;
        ev += e;
      }
    }
    Qm[r] = qm;
    Sv[r] = sv;
    Ev[r] = ev;
  }

  // the freeze entry: the first allowed entry of p whose cumulative
  // quadrant reads reach thr; then the background sums at that entry
  long long entry = -1;
  double reads = 0.0;
  const int* w = plan.words + 2 * plan.B;
  for (int e = 0; e < plan.n_e; ++e) {
    const int ep = w[0], ei = w[1], nr = w[2], nb = w[3];
    for (int i = 0; i < nr; ++i) reads = reads + Qm[w[4 + i]];
    if (ep == p && allowed[ei] != 0.0 && entry < 0 && reads >= thr)
      entry = ei;
    w += 4 + nr + nb;
  }
  double bsv = 0.0, bev = 0.0, sv_acc = 0.0, ev_acc = 0.0;
  w = plan.words + 2 * plan.B;
  for (int e = 0; e < plan.n_e; ++e) {
    const int ei = w[1], nr = w[2], nb = w[3];
    for (int i = 0; i < nb; ++i) {
      sv_acc = sv_acc + Sv[w[4 + nr + i]];
      ev_acc = ev_acc + Ev[w[4 + nr + i]];
    }
    if (entry == ei) {
      bsv = sv_acc;
      bev = ev_acc;
    }
    w += 4 + nr + nb;
  }

  const double O = (double)raw[d * Lp + x];
  const double ice = O * (w64[x] * w64[x + d]);
  const double ratio = bev != 0.0 ? bsv / bev : 0.0;
  const double E = ((ir64[d] * ratio) * b64[x]) * b64[x + d];
  const double fold = E > 0.0 ? O / E : 0.0;
  stats[t] = O;
  stats[BN + t] = E;
  stats[2 * BN + t] = fold;
  stats[3 * BN + t] = ice;
  const int count = j < kept.K
      ? (int)fmin(fmax(floor(O), 0.0), (double)(C - 1))
      : O_s[(long long)b * sus.K + k];
  cell[t] = chunk_of(E, edges, n_edges, S) * C + count;
}

// One block a (chunk s, background b) row of the [B, S, C] histogram.
__global__ void finish64_kernel(
    const int* __restrict__ hist, const int* __restrict__ cell,
    const double* __restrict__ stats, Set kept, Set sus,
    const int* __restrict__ cid_s, const int* __restrict__ O_s,
    const unsigned char* __restrict__ gap_s, const int* __restrict__ thr,
    const double* __restrict__ ptab, double sig, int B, int S, int C,
    int* __restrict__ h, double* __restrict__ qtab, double* __restrict__ rows,
    unsigned char* __restrict__ fin, long long* __restrict__ head) {
  const int s = blockIdx.x, b = blockIdx.y, nt = blockDim.x;
  const int tid = threadIdx.x;
  const int N = kept.K + sus.K;
  const long long row = (long long)b * S + s;
  int* hr = h + row * C;
  double* qr = qtab + row * C;
  const double* pr = ptab + (long long)s * C;
  const int n_s = sus.cnt[b];
  const int* new_s = cell + (long long)b * N + kept.K;

  for (int c = tid; c < C; c += nt) hr[c] = hist[row * C + c];
  __syncthreads();
  // each suspect from its device cell to its float64 one
  for (int j = tid; j < n_s; j += nt) {
    const long long i = (long long)b * sus.K + j;
    const int dev_row = min(max(cid_s[i], 0), S - 1);
    if (dev_row == s) atomicSub(&hr[O_s[i]], 1);
    if (new_s[j] / C == s) atomicAdd(&hr[new_s[j] % C], 1);
  }
  __syncthreads();

  long long m = 0;
  for (int c0 = 0; c0 < C; c0 += nt) {
    long long part;
    block_scan<long long>(c0 + tid < C ? hr[c0 + tid] : 0, 0, Add(), &part);
    m += part;
  }
  const double md = (double)m;
  // rank_max, right to left, and qraw
  long long carry = 0;
  for (int hi = C; hi > 0; hi -= nt) {
    const int c = hi - 1 - tid;
    long long part;
    const long long rm = carry + block_scan<long long>(
        c >= 0 ? hr[c] : 0, 0, Add(), &part);
    if (c >= 0)
      qr[c] = rm > 0 ? fmin(pr[c] * md / fmax((double)rm, 1.0), 1.0) : 2.0;
    carry += part;
  }
  __syncthreads();
  // within a chunk p decreases with the count: BH's suffix minimum is a
  // prefix minimum over ascending counts
  double run = 2.0;
  for (int c0 = 0; c0 < C; c0 += nt) {
    const int c = c0 + tid;
    double part;
    const double q = fmin(run, block_scan<double>(
        c < C ? qr[c] : 2.0, 2.0, Min(), &part));
    if (c < C) qr[c] = q;
    run = fmin(run, part);
  }
  __syncthreads();

  // the audit: the row without its suspects' float64 cells
  for (int j = tid; j < n_s; j += nt)
    if (new_s[j] / C == s) atomicSub(&hr[new_s[j] % C], 1);
  __syncthreads();
  if (s > 0) {
    const int thr_s = thr[row];
    long long missed = 0;
    for (int c = tid; c < C; c += nt)
      missed += qr[c] <= sig && c < thr_s && hr[c] > 0;
    for (int o = 16; o > 0; o >>= 1)
      missed += __shfl_down_sync(kFull, missed, o);
    if ((tid & 31) == 0 && missed)
      atomicAdd((unsigned long long*)&head[B + b],
                (unsigned long long)missed);
  }

  // the slots whose cell lies in this row (row 0: no chunk, or no pixel)
  const long long BN = (long long)B * N;
  for (int j = tid; j < N; j += nt) {
    const long long t = (long long)b * N + j;
    const int cl = cell[t];
    if ((cl < 0 ? 0 : cl / C) != s) continue;
    const bool is_sus = j >= kept.K;
    const int k = is_sus ? j - kept.K : j;
    const Set& st = is_sus ? sus : kept;
    const bool valid = cl >= C;
    const double p = valid ? pr[cl % C] : 1.0;
    const double q = valid ? qr[cl % C] : 1.0;
    const bool keep = cl >= 0 && q <= sig &&
                      !(is_sus && gap_s[(long long)b * sus.K + k]);
    fin[t] = keep;
    if (!keep) continue;
    atomicAdd((unsigned long long*)&head[b], 1ULL);
    const long long x = st.x[(long long)b * st.K + k];
    const long long d = st.d[(long long)b * st.K + k];
    double* r = rows + t * 7;
    r[0] = (double)x;
    r[1] = (double)(x + d);
    r[2] = stats[t];               // O
    r[3] = stats[3 * BN + t];      // ICE
    r[4] = stats[2 * BN + t];      // Fold
    r[5] = p;
    r[6] = q;
  }
}

}  // namespace

// vec64 = [w64 (Lp) | b64 (Lp) | ir64 (num_p) | allowed (by entry index)];
// O_s = the suspects' int32 [B, Ks] device counts; stats = float64 [4, B,
// K + Ks] (O, E, Fold, ICE), cell = int32 [B, K + Ks] (kept pixels first,
// then the suspects, in each background's row).
extern "C" int hp_complete64(
    const float* raw, long long num_p, long long Lp, long long L,
    long long ww_min, int maxw, const double* vec64, const int* plan,
    int n_e, int B, const int* cnt_k, const int* d_k, const int* x_k, int K,
    const int* cnt_s, const int* d_s, const int* x_s, const int* O_s, int Ks,
    double thr, const double* edges, int n_edges, int S, int C,
    double* stats, int* cell, void* stream) {
  if (maxw < 0 || maxw > kMaxW || B < 1 || K < 0 || Ks < 0 || S < 2 ||
      C < 1 || (long long)S * C > 0x7fffffffLL || n_edges < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * (K + Ks);
  if (n == 0) return (int)cudaSuccess;
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const double* w64 = vec64;
  complete64_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      raw, num_p, Lp, L, ww_min, maxw, w64, w64 + Lp, w64 + 2 * Lp,
      w64 + 2 * Lp + num_p, Plan{plan, n_e, B}, Set{cnt_k, d_k, x_k, K},
      Set{cnt_s, d_s, x_s, Ks}, O_s, thr, edges, n_edges, S, C, stats, cell);
  return (int)cudaGetLastError();
}

// hist = the int32 [B, S, C] histogram, cell and stats hp_complete64's;
// cid_s, O_s, gap_s the suspects' device chunks, counts and gap flags
// [B, Ks]; thr the device's int32 [B, S] keep thresholds; ptab float64
// [S, C]; h int32 and qtab float64 [B, S, C] scratch; rows float64
// [B * (K + Ks), 7] (x, y, O, ICE, Fold, p, q, written where kept), fin
// [B * (K + Ks)]; head int64 [2, B] zero-filled: the kept rows and the
// audit's cells a background.
extern "C" int hp_finish64(
    const int* hist, const int* cell, const double* stats, int B, int S,
    int C, const int* cnt_k, const int* d_k, const int* x_k, int K,
    const int* cnt_s, const int* d_s, const int* x_s, int Ks,
    const int* cid_s, const int* O_s, const unsigned char* gap_s,
    const int* thr, const double* ptab, double sig, int* h, double* qtab,
    double* rows, unsigned char* fin, long long* head, void* stream) {
  if (B < 1 || B > 65535 || S < 2 || C < 1 || K < 0 || Ks < 0 ||
      (long long)S * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  finish64_kernel<<<dim3((unsigned)S, (unsigned)B), 256, 0,
                    (cudaStream_t)stream>>>(
      hist, cell, stats, Set{cnt_k, d_k, x_k, K}, Set{cnt_s, d_s, x_s, Ks},
      cid_s, O_s, gap_s, thr, ptab, sig, B, S, C, h, qtab, rows, fin, head);
  return (int)cudaGetLastError();
}

