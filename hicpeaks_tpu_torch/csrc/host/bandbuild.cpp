// bandbuild: multithreaded diagonal-band scatter + derived reductions, and
// the per-pixel float64 ring sums of the host-exact statistics.
//
// The port's copy of native/bandbuild.cpp, trimmed to the two entry
// points the port calls (band_build3, ring_sums); the function bodies are
// the original's.  Built at first use by hicpeaks_tpu_torch/kernels/
// build.py with native/Makefile's flags, which fix the float contraction
// that the float64 sums depend on.
//
// The per-chromosome prep (hicpeaks_tpu_torch/ops/band.py) turns sparse
// upper-triangle pixels into a dense [num_p, Lp] float32 band plus O(L)
// vectors (per-diagonal balanced sums / NaN counts for the expected model
// of scripts/pyHICCUPS:150-158, per-bin balanced column sums for the gap
// filter of callers.py:238).  In numpy that is several boolean fancy-index
// copies and bincounts over ~1e7 pixels; this does it in one threaded pass.
// Pixels are assumed unique (ingestion dedups), so the raw scatter is
// race-free across threads.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// band_build3: band scatter with a CANONICAL per-diagonal balanced sum.
//
// Pixels scatter into a TRANSPOSED staging buffer staging[b1 * num_p + d]
// (the b1-sorted cooler stream stays on one hot page at a time), then a
// threaded blocked transpose lays out raw[d * Lp + x].  Besides raw it
// emits per-(diagonal, 128-column-block) partial sums csum_blk[num_p * nb]
// (nb = ceil(Lp/128)), which the caller folds left-to-right (numpy
// cumsum), per-diagonal NaN counts, per-bin balanced column sums,
// cand_hist[num_p] (per-diagonal nonzero-pixel counts) and out_max[1] (the
// max selected count).  The numpy and native loaders produce bit-identical
// folds because
//   * within a (d, block) cell, values accumulate in b1-ascending pixel
//     order (the input must be bin1-sorted; verified, else returns -1 and
//     the caller falls back to numpy), and
//   * thread ranges are aligned to 128-column block boundaries, so each
//     block (and each column of colsum) has exactly one writer — partials
//     merge by placement, which is exact.
// Caller contract: raw, staging ([Lp, num_p]), csum_blk, nan_counts,
// colsum, cand_hist pre-zeroed; out_dd/out_b1/out_cvals/out_ct hold >= n
// elements or are all NULL.  Returns n_selected (or -1).
extern "C" int64_t band_build3(
    const int64_t* bin1, const int64_t* bin2, const double* count, int64_t n,
    const double* weights, int64_t L, int64_t num, int64_t num_p, int64_t Lp,
    int64_t ww_min, int64_t nb, float* raw, float* staging, double* csum_blk,
    int64_t* nan_counts, double* colsum, int64_t* cand_hist, double* out_max,
    int64_t* out_dd, int64_t* out_b1, double* out_cvals, double* out_ct) {
  if (n < 0 || L <= 0 || num <= 0 || num_p < num || Lp < L) return -1;
  if (nb < (Lp + 127) / 128) return -1;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? static_cast<int64_t>(hw) : 4;
  if (n_threads > 16) n_threads = 16;
  if (n_threads < 1) n_threads = 1;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  if (chunk < 1) chunk = 1;
  bool want_out = out_dd != nullptr;

  auto selected = [&](int64_t i) -> bool {
    int64_t b1 = bin1[i], b2 = bin2[i];
    int64_t d = b2 - b1;
    return d >= 0 && d < num && b1 >= 0 && b2 < L;
  };

  // block-aligned thread ranges: advance each boundary until the bin1
  // block id changes, so no 128-column block straddles two threads
  std::vector<int64_t> bnd(n_threads + 1, 0);
  bnd[n_threads] = n;
  for (int64_t t = 1; t < n_threads; ++t) {
    int64_t i = std::min(n, t * chunk);
    while (i > 0 && i < n && (bin1[i] >> 7) == (bin1[i - 1] >> 7)) ++i;
    bnd[t] = std::max(i, bnd[t - 1]);
  }

  // phase 1: sortedness check (+ per-range selected counts if wanted)
  std::vector<int64_t> slice_counts(n_threads, 0);
  std::vector<char> sorted_l(n_threads, 1);
  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      ts.emplace_back([&, t] {
        int64_t lo = bnd[t], hi = bnd[t + 1];
        int64_t c = 0;
        char ok = 1;
        for (int64_t i = lo; i < hi; ++i) {
          if (i > 0 && bin1[i] < bin1[i - 1]) ok = 0;
          c += selected(i) ? 1 : 0;
        }
        sorted_l[t] = ok;
        slice_counts[t] = c;
      });
    }
    for (auto& th : ts) th.join();
  }
  for (int64_t t = 0; t < n_threads; ++t)
    if (!sorted_l[t]) return -1;   // caller falls back to the numpy twin
  std::vector<int64_t> offsets(n_threads + 1, 0);
  for (int64_t t = 0; t < n_threads; ++t)
    offsets[t + 1] = offsets[t] + slice_counts[t];

  // phase 2: transposed scatter; csum_blk/colsum written DIRECTLY (block
  // and column ownership is per-thread), nan/hist thread-local (integer
  // merges are exact in any order)
  std::vector<std::vector<int64_t>> nan_l(n_threads), hist_l(n_threads);
  std::vector<double> max_l(n_threads, 0.0);
  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      ts.emplace_back([&, t] {
        nan_l[t].assign(num_p, 0);
        hist_l[t].assign(num_p, 0);
        int64_t lo = bnd[t], hi = bnd[t + 1];
        int64_t o = offsets[t];
        double mx = 0.0;
        for (int64_t i = lo; i < hi; ++i) {
          if (!selected(i)) continue;
          int64_t b1 = bin1[i], b2 = bin2[i];
          int64_t d = b2 - b1;
          double ct = count[i];
          staging[b1 * num_p + d] = static_cast<float>(ct);
          if (ct > mx) mx = ct;
          if (ct != 0.0) hist_l[t][d] += 1;
          double wp = weights[b1] * weights[b2];
          double cval;
          if (std::isnan(wp)) {
            nan_l[t][d] += 1;
            cval = 0.0;
          } else {
            cval = ct * wp;
            csum_blk[d * nb + (b1 >> 7)] += cval;
            if (d >= ww_min) colsum[b1] += cval;
          }
          if (want_out) {
            out_dd[o] = d;
            out_b1[o] = b1;
            out_cvals[o] = cval;
            out_ct[o] = ct;
            ++o;
          }
        }
        max_l[t] = mx;
      });
    }
    for (auto& th : ts) th.join();
  }

  double mx = 0.0;
  for (int64_t t = 0; t < n_threads; ++t) {
    for (int64_t d = 0; d < num_p; ++d) {
      nan_counts[d] += nan_l[t][d];
      cand_hist[d] += hist_l[t][d];
    }
    if (max_l[t] > mx) mx = max_l[t];
  }
  if (out_max) *out_max = mx;

  // phase 3: blocked transpose staging[x, d] -> raw[d, x]
  {
    const int64_t TB = 64;
    int64_t n_dblk = (num + TB - 1) / TB;
    int64_t per = (n_dblk + n_threads - 1) / n_threads;
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      ts.emplace_back([&, t] {
        int64_t blo = t * per, bhi = std::min(n_dblk, (t + 1) * per);
        for (int64_t bd = blo; bd < bhi; ++bd) {
          int64_t d0 = bd * TB, d1 = std::min(num, d0 + TB);
          for (int64_t x0 = 0; x0 < L; x0 += TB) {
            int64_t x1 = std::min(L, x0 + TB);
            for (int64_t d = d0; d < d1; ++d) {
              float* dst = raw + d * Lp;
              const float* src = staging + d;
              for (int64_t x = x0; x < x1; ++x)
                dst[x] = src[x * num_p];
            }
          }
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  return offsets[n_threads];
}

// ring_sums: per-pixel, per-radius float64 window ring sums for the
// host-exact statistics replay (hicpeaks_tpu_torch/ops/hostexact.py).  The
// numpy form gathers [n, (2w+1)^2] cell temporaries and reduces them per
// (kind, radius) — ~3.7s at 18K pixels (cache-thrashing); this kernel
// walks each pixel's window once and accumulates the five ring families
// in stack-resident accumulators (~8M scalar cell visits at 18K pixels,
// threaded over pixels).  Semantics mirror hostexact._ring_sums_block
// exactly (including its tpc+dpc clip); float64 accumulation ORDER is
// sequential b-inner/a-outer, which differs from numpy's pairwise sums
// by O(cells * eps_f64) — covered by the engine's 1e-8 parity bounds
// (the reference's own accumulation order is a third order anyway).
//
//   ring_sums(raw f32[num_p, Lp], w64 f64[Lp], ir64 f64[num_p],
//             L, ww_min, maxw, d_idx i64[n], x_idx i64[n], n,
//             Qm, Kc, Qc, Ke, Qe  f64[n, maxw+1] pre-zeroed) -> 0 (or -1)
extern "C" int64_t ring_sums(
    const float* raw, int64_t num_p, int64_t Lp, const double* w64,
    const double* ir64, int64_t L, int64_t ww_min, int64_t maxw,
    const int64_t* d_idx, const int64_t* x_idx, int64_t n,
    double* Qm, double* Kc, double* Qc, double* Ke, double* Qe) {
  if (n < 0 || num_p <= 0 || Lp <= 0 || maxw < 0 || maxw > 64) return -1;
  const int64_t R = maxw + 1;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? static_cast<int64_t>(hw) : 4;
  if (n_threads > 16) n_threads = 16;
  if (n_threads < 1) n_threads = 1;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  if (chunk < 1) chunk = 1;

  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t] {
      int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
      std::vector<double> acc(5 * R);
      for (int64_t i = lo; i < hi; ++i) {
        std::fill(acc.begin(), acc.end(), 0.0);
        const int64_t d = d_idx[i], x = x_idx[i];
        for (int64_t a = -maxw; a <= maxw; ++a) {
          const int64_t tp = x + a;
          for (int64_t b = -maxw; b <= maxw; ++b) {
            const int64_t r = std::max(std::llabs(a), std::llabs(b));
            if (r == 0) continue;
            const bool is_k = (a != 0) && (b != 0);
            const bool is_q = (a >= 1) && (b <= -1);
            if (!is_k && !is_q) continue;
            const int64_t dp = d + b - a;
            const bool inb = dp >= 0 && dp < num_p && tp >= 0 && tp < Lp;
            double rawv = 0.0, cv = 0.0, ev = 0.0;
            if (inb) {
              rawv = static_cast<double>(raw[dp * Lp + tp]);
              if (dp >= ww_min) {
                int64_t yc = tp + dp;
                if (yc > Lp - 1) yc = Lp - 1;
                cv = rawv * w64[tp] * w64[yc];
              }
              if (tp < L - dp) ev = ir64[dp];
            }
            double* row = acc.data();
            if (is_q) row[0 * R + r] += rawv;          // Qm
            if (is_k) row[1 * R + r] += cv;            // Kc
            if (is_q) row[2 * R + r] += cv;            // Qc
            if (is_k) row[3 * R + r] += ev;            // Ke
            if (is_q) row[4 * R + r] += ev;            // Qe
          }
        }
        double* outs[5] = {Qm, Kc, Qc, Ke, Qe};
        for (int k = 0; k < 5; ++k)
          std::memcpy(outs[k] + i * R, acc.data() + k * R,
                      R * sizeof(double));
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}
