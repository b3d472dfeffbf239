// Native FCIDUMP body parser (data-loader hot path).
//
// The FCIDUMP integral format (reference reader:
// pauxy/utils/hamiltonian_converter.py:8-100) is a text file with one
// integral per line; molecular files reach 1e6-1e8 lines, and a Python
// regex-per-line parse becomes the dominant setup cost before the device ever
// sees work.  This translation unit parses the *body* (the Python layer
// parses the short &FCI header) with std::from_chars straight off one
// in-memory buffer — locale-independent by definition, unlike strtod whose
// decimal point follows LC_NUMERIC — and applies the 8-fold permutational
// symmetry fill into caller-allocated numpy arrays.  No allocation, no
// copies, no exceptions across the C ABI.  Orbital indices are validated
// against norb before any store: a malformed index returns an error offset
// instead of writing out of bounds of the caller's buffers.
//
// Exposed via ctypes (see native/__init__.py); the pure-Python parser in
// utils/qmcpack.read_fcidump remains the behavioural oracle and fallback.

#include <charconv>
#include <cstdint>

namespace {

// Advance past whitespace (entries are whitespace separated and
// self-delimiting; line structure is irrelevant here).
inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

// Locale-independent double parse with optional leading '+' (from_chars
// accepts '-' but not '+'; FCIDUMP writers emit both).  Returns the
// position after the number, or nullptr on failure.
inline const char *parse_double(const char *p, const char *end, double *out) {
  if (p < end && *p == '+') ++p;
  auto res = std::from_chars(p, end, *out);
  return res.ec == std::errc() ? res.ptr : nullptr;
}

inline const char *parse_long(const char *p, const char *end, long *out) {
  if (p < end && *p == '+') ++p;
  auto res = std::from_chars(p, end, *out);
  return res.ec == std::errc() ? res.ptr : nullptr;
}

// Fill the 8 permutations (chemist (ij|kl) real symmetry) with {vr, vi}.
// cplx selects interleaved complex128 storage (stride 2 doubles).
inline void fill8(double *eri, long n, long i, long j, long k, long l,
                  double vr, double vi, bool cplx) {
  const long perms[8][4] = {
      {i, j, k, l}, {j, i, k, l}, {i, j, l, k}, {j, i, l, k},
      {k, l, i, j}, {l, k, i, j}, {k, l, j, i}, {l, k, j, i}};
  const long s = cplx ? 2 : 1;
  for (auto &p : perms) {
    long idx = ((p[0] * n + p[1]) * n + p[2]) * n + p[3];
    eri[idx * s] = vr;
    if (cplx) eri[idx * s + 1] = vi;
  }
}

}  // namespace

extern "C" {

// Parse the FCIDUMP body in buf[0..len) for a norb-orbital system.
//   h1e:  [norb, norb] doubles (cplx=0) or complex128-as-double-pairs
//   eri:  [norb^4] likewise
//   ecore: 1 (or 2) doubles
// Returns the number of integral entries consumed, or -(byte offset + 1)
// of the first malformed entry — including any entry whose orbital indices
// fall outside [0, norb] or whose zero pattern matches no valid entry kind
// (the Python caller raises/falls back; nothing is written for a bad
// entry).  Unparseable trailing garbage on a line (e.g. comments) is not
// supported — the writers never produce it.
long pauxy_fcidump_fill(const char *buf, long len, long norb, int cplx,
                        double *h1e, double *eri, double *ecore) {
  const char *p = buf;
  const char *end = buf + len;
  long count = 0;
  while (true) {
    p = skip_ws(p, end);
    if (p >= end) break;
    const char *entry = p;  // error offsets point at the entry start
    double vr = 0.0, vi = 0.0;
    const char *q = nullptr;
    if (cplx) {
      if (*p != '(') return -(long)(entry - buf) - 1;
      p = skip_ws(p + 1, end);
      q = parse_double(p, end, &vr);
      if (!q) return -(long)(entry - buf) - 1;
      p = skip_ws(q, end);
      if (p < end && *p == ',') p = skip_ws(p + 1, end);
      q = parse_double(p, end, &vi);
      if (!q) return -(long)(entry - buf) - 1;
      p = skip_ws(q, end);
      if (p < end && *p == ')') ++p;
    } else {
      q = parse_double(p, end, &vr);
      if (!q) return -(long)(entry - buf) - 1;
      p = q;
    }
    long ix[4];
    for (int t = 0; t < 4; ++t) {
      p = skip_ws(p, end);
      q = parse_long(p, end, &ix[t]);
      if (!q) return -(long)(entry - buf) - 1;
      p = q;
      // Bounds gate BEFORE any branch below touches the arrays: 1-based
      // orbital indices, 0 = "unused slot" sentinel.
      if (ix[t] < 0 || ix[t] > norb) return -(long)(entry - buf) - 1;
    }
    const long i = ix[0], j = ix[1], k = ix[2], l = ix[3];
    const long s = cplx ? 2 : 1;
    if (i == 0 && j == 0 && k == 0 && l == 0) {
      ecore[0] = vr;
      if (cplx) ecore[1] = vi;
    } else if (k == 0 && l == 0) {
      // One-body: Hermitian fill (conjugate transpose element).  Both
      // indices must be real orbitals.
      if (i == 0 || j == 0) return -(long)(entry - buf) - 1;
      long a = (i - 1) * norb + (j - 1), b = (j - 1) * norb + (i - 1);
      h1e[a * s] = vr;
      h1e[b * s] = vr;
      if (cplx) {
        h1e[a * s + 1] = vi;
        h1e[b * s + 1] = -vi;
      }
    } else {
      // Two-body: all four indices must be real orbitals.
      if (i == 0 || j == 0 || k == 0 || l == 0)
        return -(long)(entry - buf) - 1;
      fill8(eri, norb, i - 1, j - 1, k - 1, l - 1, vr, vi, cplx != 0);
    }
    ++count;
  }
  return count;
}

}  // extern "C"
