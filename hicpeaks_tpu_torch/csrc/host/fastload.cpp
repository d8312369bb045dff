// fastload: multithreaded parser for 3-column Hi-C text files
// ("bin1 bin2 count" per line, the reference ingestion format documented
// at README.rst:148-163).  Replaces the reference's np.loadtxt hot loop
// (hicpeaks/utilities.py:286) which dominates its toCooler wall-clock
// (README.rst:287-291: ~1h for 140M contacts).  mmap + hand-rolled
// integer/float scanning, one thread per file slice.
//
// C ABI for ctypes:
//   fastload_count(path) -> int64 line-capacity estimate (or -1)
//   fastload_parse(path, bin1*, bin2*, count*, cap) -> rows parsed (or -1)
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct Slice {
  const char* begin;
  const char* end;
  int64_t out_off;   // starting row in the output arrays
  int64_t rows;      // rows parsed
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  *out = neg ? -v : v;
  return p;
}

// parse a floating count (plain or scientific); most files carry integers,
// so the fast path is the integer scan.
inline const char* parse_f64(const char* p, const char* end, double* out) {
  char buf[64];
  size_t n = 0;
  const char* q = p;
  while (q < end && n < sizeof(buf) - 1 &&
         ((*q >= '0' && *q <= '9') || *q == '.' || *q == '-' || *q == '+' ||
          *q == 'e' || *q == 'E')) {
    buf[n++] = *q++;
  }
  buf[n] = 0;
  *out = strtod(buf, nullptr);
  return q;
}

void parse_slice(Slice* s, int64_t* b1, int64_t* b2, double* ct) {
  const char* p = s->begin;
  const char* end = s->end;
  int64_t row = s->out_off;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '#') {                       // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    int64_t a, b;
    double c;
    p = parse_i64(p, end, &a);
    p = skip_ws(p, end);
    p = parse_i64(p, end, &b);
    p = skip_ws(p, end);
    p = parse_f64(p, end, &c);
    while (p < end && *p != '\n') ++p;     // tolerate trailing columns
    b1[row] = a;
    b2[row] = b;
    ct[row] = c;
    ++row;
  }
  s->rows = row - s->out_off;
}

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr || size == 0; }
  ~Mapped() {
    if (data && size) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return false;
  struct stat st;
  if (fstat(m->fd, &st) != 0) return false;
  m->size = static_cast<size_t>(st.st_size);
  if (m->size == 0) return true;
  void* p = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) return false;
  m->data = static_cast<const char*>(p);
  return true;
}

}  // namespace

extern "C" {

int64_t fastload_count(const char* path) {
  Mapped m;
  if (!map_file(path, &m) || !m.ok()) return -1;
  int64_t lines = 0;
  const char* p = m.data;
  const char* end = m.data + m.size;
  // count newlines in parallel
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 4;
  std::vector<int64_t> counts(nthreads, 0);
  std::vector<std::thread> threads;
  size_t chunk = m.size / nthreads + 1;
  for (unsigned t = 0; t < nthreads; ++t) {
    const char* cb = p + std::min<size_t>(t * chunk, m.size);
    const char* ce = p + std::min<size_t>((t + 1) * chunk, m.size);
    threads.emplace_back([cb, ce, &counts, t] {
      int64_t n = 0;
      for (const char* q = cb; q < ce; ++q)
        if (*q == '\n') ++n;
      counts[t] = n;
    });
  }
  for (auto& th : threads) th.join();
  for (auto c : counts) lines += c;
  if (m.size && end[-1] != '\n') ++lines;  // unterminated last line
  return lines;
}

int64_t fastload_parse(const char* path, int64_t* b1, int64_t* b2, double* ct,
                       int64_t cap) {
  Mapped m;
  if (!map_file(path, &m) || !m.ok()) return -1;
  if (m.size == 0) return 0;

  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 4;
  // first pass: per-slice line counts to fix output offsets
  const char* base = m.data;
  const char* end = m.data + m.size;
  std::vector<Slice> slices;
  size_t chunk = m.size / nthreads + 1;
  const char* cur = base;
  for (unsigned t = 0; t < nthreads && cur < end; ++t) {
    const char* ce = base + std::min<size_t>((t + 1) * chunk, m.size);
    if (ce < end) {                       // extend to the next newline
      while (ce < end && *ce != '\n') ++ce;
      if (ce < end) ++ce;
    }
    slices.push_back({cur, ce, 0, 0});
    cur = ce;
  }
  std::vector<int64_t> lines(slices.size(), 0);
  {
    std::vector<std::thread> threads;
    for (size_t t = 0; t < slices.size(); ++t) {
      threads.emplace_back([&, t] {
        int64_t n = 0;
        bool in_line = false;
        for (const char* q = slices[t].begin; q < slices[t].end; ++q) {
          if (*q == '\n') { in_line = false; }
          else if (!in_line) { in_line = true; ++n; }
        }
        lines[t] = n;
      });
    }
    for (auto& th : threads) th.join();
  }
  int64_t off = 0;
  for (size_t t = 0; t < slices.size(); ++t) {
    slices[t].out_off = off;
    off += lines[t];
  }
  if (off > cap) return -2;               // caller's buffer too small

  std::vector<std::thread> threads;
  for (auto& s : slices)
    threads.emplace_back(parse_slice, &s, b1, b2, ct);
  for (auto& th : threads) th.join();

  // slices may contain blank/comment lines: compact if any slice parsed
  // fewer rows than its reserved span
  int64_t write = 0;
  for (auto& s : slices) {
    if (s.out_off != write) {
      memmove(b1 + write, b1 + s.out_off, s.rows * sizeof(int64_t));
      memmove(b2 + write, b2 + s.out_off, s.rows * sizeof(int64_t));
      memmove(ct + write, ct + s.out_off, s.rows * sizeof(double));
    }
    write += s.rows;
  }
  return write;
}

}  // extern "C"
