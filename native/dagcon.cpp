// tpu-dagcon native engine: streaming parser, gap normalizer, alignment
// graph (build + merge), linearizer, float32 best-path DP, consensus
// emission, and a pthread-style worker pool — the C++ runtime around the
// device compute path.
//
// This is a from-scratch implementation of SPEC.md §1–§3 (normative; the
// reference mount was empty — reconstructed behavior of upstream
// pbdagcon's src/cpp/Alignment.cpp and src/cpp/AlnGraphBoost.cpp, see
// SURVEY.md §2 C1–C6). It must agree bit-for-bit with the Python oracle
// (pbdagcon_tpu/oracle/graph.py); tests/test_native.py enforces this
// differentially. All path arithmetic is strict IEEE float32 — do NOT
// compile with -ffast-math.
//
// C ABI at the bottom; Python binds via ctypes (pbdagcon_tpu/native.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <queue>
#include <string>
#include <mutex>
#include <thread>
#include <tuple>
#include <vector>

namespace dagcon {

static const float kPenalty = -10.0f;
static const float kNegMax = -3.4028234663852886e38f;  // -FLT_MAX
static const float kNegInf = -__builtin_inff();

// ---------------------------------------------------------------- records

struct Alignment {
  std::string id, sid;
  int32_t tlen = 0;
  int32_t start = 1;  // 1-based on forward target
  int32_t end = 0;
  std::string qstr, tstr;

  void recompute_end() {
    int32_t t = 0;
    for (char c : tstr)
      if (c != '-') ++t;
    end = start - 1 + t;
  }
  bool empty() const { return qstr.empty(); }
};

static inline char comp(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    default: return c;  // N, '-', anything else maps to itself
  }
}

static void revcomp_inplace(std::string& s) {
  std::reverse(s.begin(), s.end());
  for (char& c : s) c = comp(c);
}

// Split one whitespace-separated line into fields (no allocation churn).
static void split_ws(const char* p, const char* end,
                     std::vector<std::pair<const char*, size_t>>& out) {
  out.clear();
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    const char* s = p;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
    if (p > s) out.emplace_back(s, (size_t)(p - s));
  }
}

static int64_t to_i64(const char* s, size_t n) {
  int64_t v = 0;
  bool neg = false;
  size_t i = 0;
  if (n && (s[0] == '-' || s[0] == '+')) {
    neg = s[0] == '-';
    i = 1;
  }
  for (; i < n; ++i) v = v * 10 + (s[i] - '0');
  return neg ? -v : v;
}

// Parse one M5 record: 19 whitespace fields (SPEC §1.1). Returns false on
// malformed input.
static bool parse_m5(const char* line, const char* end, Alignment& a) {
  std::vector<std::pair<const char*, size_t>> f;
  split_ws(line, end, f);
  if (f.size() != 19) return false;
  a.id.assign(f[0].first, f[0].second);
  a.sid.assign(f[5].first, f[5].second);
  a.tlen = (int32_t)to_i64(f[6].first, f[6].second);
  int64_t tstart = to_i64(f[7].first, f[7].second);
  int64_t tend = to_i64(f[8].first, f[8].second);
  bool flip = !(f[4].second == f[9].second &&
                memcmp(f[4].first, f[9].first, f[4].second) == 0);
  a.qstr.assign(f[16].first, f[16].second);
  a.tstr.assign(f[18].first, f[18].second);
  if (a.qstr.size() != a.tstr.size()) return false;
  if (flip) {
    revcomp_inplace(a.qstr);
    revcomp_inplace(a.tstr);
    a.start = (int32_t)(a.tlen - tend + 1);
  } else {
    a.start = (int32_t)(tstart + 1);
  }
  a.recompute_end();
  return true;
}

// Parse one 'pre' record: 7 fields (SPEC §1.2).
static bool parse_pre(const char* line, const char* end, Alignment& a) {
  std::vector<std::pair<const char*, size_t>> f;
  split_ws(line, end, f);
  if (f.size() != 7) return false;
  a.id.assign(f[0].first, f[0].second);
  a.sid.assign(f[1].first, f[1].second);
  a.start = (int32_t)to_i64(f[2].first, f[2].second);
  a.end = (int32_t)to_i64(f[3].first, f[3].second);
  a.tlen = (int32_t)to_i64(f[4].first, f[4].second);
  a.qstr.assign(f[5].first, f[5].second);
  a.tstr.assign(f[6].first, f[6].second);
  // Lengths may differ for RAW pairs (the -a re-alignment path).
  return true;
}

// -------------------------------------------------- normalization / trim

// Reusable per-thread scratch for normalize_gaps (allocation-free steady
// state; the normalizer runs once per alignment record).
struct NormScratch {
  std::string qn, tn, oq, ot;
};

// SPEC §1.3: mismatch expansion, right gap-pushing, double-gap removal.
static void normalize_gaps(Alignment& a, NormScratch& ns) {
  const std::string& q = a.qstr;
  const std::string& t = a.tstr;
  std::string& qn = ns.qn;
  std::string& tn = ns.tn;
  qn.clear();
  tn.clear();
  qn.reserve(q.size() * 2);
  tn.reserve(t.size() * 2);
  for (size_t i = 0; i < q.size(); ++i) {
    char qb = q[i], tb = t[i];
    if (qb != tb && qb != '-' && tb != '-') {
      qn.push_back('-');
      qn.push_back(qb);
      tn.push_back(tb);
      tn.push_back('-');
    } else {
      qn.push_back(qb);
      tn.push_back(tb);
    }
  }
  size_t n = qn.size();
  for (size_t i = 0; i + 1 < n; ++i) {
    if (tn[i] == '-') {
      for (size_t j = i + 1; j < n; ++j) {
        char c = tn[j];
        if (c != '-') {
          if (c == qn[i]) {
            tn[i] = c;
            tn[j] = '-';
          }
          break;
        }
      }
    }
    if (qn[i] == '-') {
      for (size_t j = i + 1; j < n; ++j) {
        char c = qn[j];
        if (c != '-') {
          if (c == tn[i]) {
            qn[i] = c;
            qn[j] = '-';
          }
          break;
        }
      }
    }
  }
  std::string& oq = ns.oq;
  std::string& ot = ns.ot;
  oq.clear();
  ot.clear();
  oq.reserve(n);
  ot.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    if (qn[i] != '-' || tn[i] != '-') {
      oq.push_back(qn[i]);
      ot.push_back(tn[i]);
    }
  }
  a.qstr.assign(oq);
  a.tstr.assign(ot);
  a.recompute_end();
}

// SPEC §1.4: trim n aligned query bases off each end.
static void trim_aln(Alignment& a, int32_t n) {
  if (n <= 0) return;
  const std::string& q = a.qstr;
  const std::string& t = a.tstr;
  size_t len = q.size();
  size_t i = 0;
  int32_t removed_q = 0, start_shift = 0;
  while (i < len && removed_q < n) {
    if (q[i] != '-') ++removed_q;
    if (t[i] != '-') ++start_shift;
    ++i;
  }
  size_t j = len;
  removed_q = 0;
  while (j > i && removed_q < n) {
    --j;
    if (q[j] != '-') ++removed_q;
  }
  a.start += start_shift;
  a.qstr = q.substr(i, j - i);
  a.tstr = t.substr(i, j - i);
  a.recompute_end();
}

// -------------------------------------------------------------- aligner

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#include <climits>
#endif

// Prefix max over int32 with an initial carry (integer max is exact
// under any association, so the SIMD log-step scan is bit-safe).
static inline void prefix_max_i32(int32_t* x, int n, int32_t carry) {
#if defined(__AVX512F__)
  int j = 0;
  __m512i c = _mm512_set1_epi32(carry);
  const __m512i ninf = _mm512_set1_epi32(INT32_MIN);
  for (; j + 16 <= n; j += 16) {
    __m512i v = _mm512_loadu_si512((const void*)(x + j));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 15));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 14));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 12));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 8));
    v = _mm512_max_epi32(v, c);
    _mm512_storeu_si512((void*)(x + j), v);
    c = _mm512_permutexvar_epi32(_mm512_set1_epi32(15), v);
  }
  int32_t run = _mm_cvtsi128_si32(_mm512_castsi512_si128(c));
  for (; j < n; ++j) {
    if (x[j] > run) run = x[j];
    x[j] = run;
  }
#else
  int32_t run = carry;
  for (int j = 0; j < n; ++j) {
    if (x[j] > run) run = x[j];
    x[j] = run;
  }
#endif
}

// Fused left-chain solve for one aligner row: out[k] = max_{k'<=k}
// (x[k'] + GAP*(k-k')) with `carry` seeding position -1. x[] holds
// a-space candidates (cand[k] - GAP*k); the scan is a plain prefix max
// there, and the store de-ramps back to score space. One sweep instead
// of prefix_max + two ramp passes; all ops are int32 adds/maxes, so
// the result is bit-identical to the sequential chain.
static inline void prefix_max_store_i32(const int32_t* x, int32_t* out,
                                        int n, int32_t carry,
                                        int32_t gap) {
#if defined(__AVX512F__)
  int j = 0;
  __m512i c = _mm512_set1_epi32(carry);
  const __m512i ninf = _mm512_set1_epi32(INT32_MIN);
  const __m512i lane = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                         10, 11, 12, 13, 14, 15);
  const __m512i ramp0 =
      _mm512_mullo_epi32(lane, _mm512_set1_epi32(gap));
  const __m512i step = _mm512_set1_epi32(gap * 16);
  __m512i ramp = ramp0;
  for (; j + 16 <= n; j += 16) {
    __m512i v = _mm512_loadu_si512((const void*)(x + j));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 15));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 14));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 12));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 8));
    v = _mm512_max_epi32(v, c);
    _mm512_storeu_si512((void*)(out + j), _mm512_add_epi32(v, ramp));
    ramp = _mm512_add_epi32(ramp, step);
    c = _mm512_permutexvar_epi32(_mm512_set1_epi32(15), v);
  }
  int32_t run = _mm_cvtsi128_si32(_mm512_castsi512_si128(c));
  for (; j < n; ++j) {
    if (x[j] > run) run = x[j];
    out[j] = run + gap * j;
  }
#else
  int32_t run = carry;
  for (int j = 0; j < n; ++j) {
    if (x[j] > run) run = x[j];
    out[j] = run + gap * j;
  }
#endif
}

// Banded global pairwise aligner (SPEC §1.5) — the SimpleAligner
// equivalent (reference `src/cpp/SimpleAligner.cpp` wraps blasr_libcpp's
// guided aligner, SURVEY.md §2 C8; reconstructed, mount empty). Integer
// DP; must agree exactly with pbdagcon_tpu/aligner.py (and the batched
// device kernel). Scratch reused per worker.
struct AlignScratch {
  std::vector<int32_t> H;  // band-only rows, (m+1) x (2*bw+1)
  std::vector<int32_t> lo, hi;  // per-row band bounds
  std::vector<int32_t> tmp;  // row candidate buffer (pass 1)
  std::string qs, ts;
};

static const int32_t A_MATCH = 1, A_MISMATCH = -2, A_GAP = -3;
static const int32_t A_NEG = -(1 << 30);

static void align_pair(const std::string& q, const std::string& t,
                       std::string& out_q, std::string& out_t,
                       AlignScratch& as) {
  int32_t m = (int32_t)q.size(), n = (int32_t)t.size();
  if (m == 0) {
    out_q.assign((size_t)n, '-');
    out_t = t;
    return;
  }
  if (n == 0) {
    out_q = q;
    out_t.assign((size_t)m, '-');
    return;
  }
  int64_t bw64 = std::max<int64_t>(64, std::abs((int64_t)m - n) + 32);
  int32_t bw = (int32_t)bw64;
  // Band-only storage: row i covers columns [lo_i, hi_i]; cells outside
  // are reconstructed analytically (borders) or -inf. No per-pair
  // memset — every stored cell is written before it is read. This is
  // semantically identical to the full-matrix banded fill (SPEC §1.5):
  // out-of-band reads return the same NEG/border values.
  int32_t Wb = 2 * bw + 1;
  as.H.resize(((size_t)m + 1) * Wb);
  int32_t* band = as.H.data();
  as.lo.resize((size_t)m + 1);
  as.hi.resize((size_t)m + 1);
  int32_t* lo = as.lo.data();
  int32_t* hi = as.hi.data();
  lo[0] = 1;
  hi[0] = 0;  // row 0 stores nothing (analytic border)
  for (int32_t i = 1; i <= m; ++i) {
    int32_t center = (int32_t)((int64_t)i * n / m);
    lo[i] = std::max(1, center - bw);
    hi[i] = std::min(n, center + bw);
  }
  auto get = [&](int32_t i, int32_t j) -> int32_t {
    if (i == 0) return A_GAP * j;
    if (j == 0) return A_GAP * i;
    if (j < lo[i] || j > hi[i]) return A_NEG;
    return band[(size_t)i * Wb + (j - lo[i])];
  };
  as.tmp.resize((size_t)Wb + 2);
  int32_t* tmp = as.tmp.data();
  for (int32_t i = 1; i <= m; ++i) {
    char qc = q[i - 1];
    const int32_t l = lo[i], h = hi[i];
    const int32_t* prev = band + (size_t)(i - 1) * Wb;
    int32_t plo = lo[i - 1], phi = hi[i - 1];
    int32_t* row = band + (size_t)i * Wb;
    // Pass 1 (vectorizable): tmp holds the A-SPACE candidate
    // a[k] = max(diag + sub, up + GAP) - GAP*k (k = band index).
    // Interior cells read the previous band contiguously; edges where
    // the previous row's band doesn't cover j-1 / j are patched after.
    if (i == 1) {
      for (int32_t j = l; j <= h; ++j) {
        int32_t sub = (qc == t[j - 1]) ? A_MATCH : A_MISMATCH;
        int32_t v = A_GAP * (j - 1) + sub;
        int32_t u2 = A_GAP * j + A_GAP;
        tmp[j - l] = (v > u2 ? v : u2) - A_GAP * (j - l);
      }
    } else {
      int32_t j0 = std::max(l, plo + 1);   // j-1 >= plo
      int32_t j1 = std::min(h, phi);       // j <= phi (and j-1 <= phi-1)
      const int32_t* pd = prev + (j0 - 1 - plo);
      const int32_t* pu = prev + (j0 - plo);
      const char* tb = t.data() + (j0 - 1);
      int32_t* tp = tmp + (j0 - l);
      int32_t cnt = j1 - j0 + 1;
      const int32_t off = j0 - l;
      for (int32_t k = 0; k < cnt; ++k) {
        int32_t sub = (qc == tb[k]) ? A_MATCH : A_MISMATCH;
        int32_t v = pd[k] + sub;
        int32_t u2 = pu[k] + A_GAP;
        tp[k] = (v > u2 ? v : u2) - A_GAP * (k + off);
      }
      // Edge cells (at most a few per row).
      for (int32_t j = l; j < j0 && j <= h; ++j) {
        int32_t diag = (j - 1 == 0) ? A_GAP * (i - 1)
                       : (j - 1 < plo || j - 1 > phi) ? A_NEG
                                                      : prev[j - 1 - plo];
        int32_t up = (j < plo || j > phi) ? A_NEG : prev[j - plo];
        int32_t sub = (qc == t[j - 1]) ? A_MATCH : A_MISMATCH;
        int32_t v = diag + sub;
        int32_t u2 = up + A_GAP;
        tmp[j - l] = (v > u2 ? v : u2) - A_GAP * (j - l);
      }
      for (int32_t j = std::max(j1 + 1, l); j <= h; ++j) {
        int32_t diag = (j - 1 < plo || j - 1 > phi) ? A_NEG
                                                    : prev[j - 1 - plo];
        int32_t up = (j < plo || j > phi) ? A_NEG : prev[j - plo];
        int32_t sub = (qc == t[j - 1]) ? A_MATCH : A_MISMATCH;
        int32_t v = diag + sub;
        int32_t u2 = up + A_GAP;
        tmp[j - l] = (v > u2 ? v : u2) - A_GAP * (j - l);
      }
    }
    // Pass 2: row[k] = max_{k'<=k}(tmp-space) + GAP*k with the left
    // border as a-space seed — one fused scan+store sweep. Integer
    // max/add is exact under any association, so this is bit-identical
    // to the sequential left chain.
    prefix_max_store_i32(tmp, row, h - l + 1, get(i, l - 1) + A_GAP,
                         A_GAP);
  }
  // Traceback; tie-break diagonal > up (gap in t) > left (gap in q).
  std::string& qs = as.qs;
  std::string& ts = as.ts;
  qs.clear();
  ts.clear();
  int32_t i = m, j = n;
  while (i > 0 || j > 0) {
    int32_t h = get(i, j);
    if (i > 0 && j > 0 &&
        h == get(i - 1, j - 1) +
                 (q[i - 1] == t[j - 1] ? A_MATCH : A_MISMATCH)) {
      qs.push_back(q[i - 1]);
      ts.push_back(t[j - 1]);
      --i;
      --j;
    } else if (i > 0 && h == get(i - 1, j) + A_GAP) {
      qs.push_back(q[i - 1]);
      ts.push_back('-');
      --i;
    } else {
      qs.push_back('-');
      ts.push_back(t[j - 1]);
      --j;
    }
  }
  out_q.assign(qs.rbegin(), qs.rend());
  out_t.assign(ts.rbegin(), ts.rend());
}

// Affine-gap banded aligner (SPEC §1.6) — alternate scorer for the -a
// path. The reference's SimpleAligner wraps blasr_libcpp's guided
// affine aligner (`src/cpp/SimpleAligner.cpp`, SURVEY.md §2 C8;
// parameters unreadable — mount empty), so the exact scheme cannot be
// matched yet; this Gotoh scorer exists to (a) expose an affine option
// and (b) measure consensus sensitivity to the scorer
// (docs/SCORER_SENSITIVITY.md). Must agree exactly with
// pbdagcon_tpu/aligner.py::align_pair_affine.
//
// Gap of length k scores open + (k-1)*extend, with open <= extend <= 0
// (enforced by config validation) so a single long gap always beats two
// adjacent gaps. Tie-breaks (normative): in H, diag > up (gap in t) >
// left (gap in q); in a gap state, close (reopen from H) > extend.
struct AffineParams {
  int32_t match = 1, mismatch = -2, open = -4, extend = -1;
};

struct AffineScratch {
  std::vector<int32_t> H, U, Lf;  // band-only rows, (m+1) x (2*bw+1)
  std::vector<int32_t> lo, hi;
  std::string qs, ts;
};

static void align_pair_affine(const std::string& q, const std::string& t,
                              std::string& out_q, std::string& out_t,
                              AffineScratch& as, const AffineParams& pp) {
  const int32_t M = pp.match, X = pp.mismatch, O = pp.open, E = pp.extend;
  int32_t m = (int32_t)q.size(), n = (int32_t)t.size();
  if (m == 0) {
    out_q.assign((size_t)n, '-');
    out_t = t;
    return;
  }
  if (n == 0) {
    out_q = q;
    out_t.assign((size_t)m, '-');
    return;
  }
  int64_t bw64 = std::max<int64_t>(64, std::abs((int64_t)m - n) + 32);
  int32_t bw = (int32_t)bw64;
  int32_t Wb = 2 * bw + 1;
  as.H.resize(((size_t)m + 1) * Wb);
  as.U.resize(((size_t)m + 1) * Wb);
  as.Lf.resize(((size_t)m + 1) * Wb);
  as.lo.resize((size_t)m + 1);
  as.hi.resize((size_t)m + 1);
  int32_t* Hb = as.H.data();
  int32_t* Ub = as.U.data();
  int32_t* Lb = as.Lf.data();
  int32_t* lo = as.lo.data();
  int32_t* hi = as.hi.data();
  lo[0] = 1;
  hi[0] = 0;  // row 0 is analytic border
  for (int32_t i = 1; i <= m; ++i) {
    int32_t center = (int32_t)((int64_t)i * n / m);
    lo[i] = std::max(1, center - bw);
    hi[i] = std::min(n, center + bw);
  }
  auto border = [&](int32_t k) -> int32_t { return O + (k - 1) * E; };
  auto Hget = [&](int32_t i, int32_t j) -> int32_t {
    if (i == 0) return j == 0 ? 0 : border(j);
    if (j == 0) return border(i);
    if (j < lo[i] || j > hi[i]) return A_NEG;
    return Hb[(size_t)i * Wb + (j - lo[i])];
  };
  auto Uget = [&](int32_t i, int32_t j) -> int32_t {
    if (i == 0) return A_NEG;
    if (j == 0) return border(i);
    if (j < lo[i] || j > hi[i]) return A_NEG;
    return Ub[(size_t)i * Wb + (j - lo[i])];
  };
  auto Lget = [&](int32_t i, int32_t j) -> int32_t {
    if (j == 0) return A_NEG;
    if (i == 0) return border(j);
    if (j < lo[i] || j > hi[i]) return A_NEG;
    return Lb[(size_t)i * Wb + (j - lo[i])];
  };
  for (int32_t i = 1; i <= m; ++i) {
    const char qc = q[i - 1];
    const int32_t l = lo[i], h = hi[i];
    int32_t* Hr = Hb + (size_t)i * Wb;
    int32_t* Ur = Ub + (size_t)i * Wb;
    int32_t* Lr = Lb + (size_t)i * Wb;
    int32_t left_h = Hget(i, l - 1);
    int32_t left_l = Lget(i, l - 1);
    for (int32_t j = l; j <= h; ++j) {
      int32_t up_h = Hget(i - 1, j);
      int32_t up_u = Uget(i - 1, j);
      int32_t u = std::max(up_h == A_NEG ? A_NEG : up_h + O,
                           up_u == A_NEG ? A_NEG : up_u + E);
      int32_t lf = std::max(left_h == A_NEG ? A_NEG : left_h + O,
                            left_l == A_NEG ? A_NEG : left_l + E);
      int32_t dg = Hget(i - 1, j - 1);
      int32_t v = dg == A_NEG ? A_NEG
                              : dg + ((qc == t[j - 1]) ? M : X);
      v = std::max(v, std::max(u, lf));
      Hr[j - l] = v;
      Ur[j - l] = u;
      Lr[j - l] = lf;
      left_h = v;
      left_l = lf;
    }
  }
  // Traceback with the normative state-machine tie-break.
  std::string& qs = as.qs;
  std::string& ts = as.ts;
  qs.clear();
  ts.clear();
  int32_t i = m, j = n;
  int state = 0;  // 0=H, 1=U (gap in t), 2=L (gap in q)
  while (i > 0 || j > 0) {
    if (state == 0) {
      int32_t hv = Hget(i, j);
      if (i > 0 && j > 0 &&
          hv == Hget(i - 1, j - 1) + (q[i - 1] == t[j - 1] ? M : X)) {
        qs.push_back(q[i - 1]);
        ts.push_back(t[j - 1]);
        --i;
        --j;
      } else if (i > 0 && hv == Uget(i, j)) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      int32_t uv = Uget(i, j);
      qs.push_back(q[i - 1]);
      ts.push_back('-');
      if (Hget(i - 1, j) != A_NEG && uv == Hget(i - 1, j) + O) state = 0;
      --i;
    } else {
      int32_t lv = Lget(i, j);
      qs.push_back('-');
      ts.push_back(t[j - 1]);
      if (Hget(i, j - 1) != A_NEG && lv == Hget(i, j - 1) + O) state = 0;
      --j;
    }
  }
  out_q.assign(qs.rbegin(), qs.rend());
  out_t.assign(ts.rbegin(), ts.rend());
}

// ------------------------------------------------------------------ graph

struct Edge {
  int32_t to;
  int32_t count;
};
struct REdge {
  int32_t from;
  int32_t count;
};

// Backbone-seeded POA DAG (SPEC §2). Creation-ordered adjacency vectors
// mirror the oracle's insertion-ordered dicts — order is parity-critical.
//
// The structure is REUSED across targets (per worker thread): `init`
// keeps every inner adjacency vector's heap capacity, so steady-state
// graph building is allocation-free — this is the hottest loop of the
// whole program (SURVEY.md §3.1) and malloc churn dominated the naive
// vector-of-vectors version.
struct Graph {
  int32_t L = 0, enter = 0, exit = 0;
  int32_t n = 0;  // active node count; arrays below may be larger
  std::vector<uint8_t> base;
  std::vector<int32_t> weight, coverage, anchor;
  std::vector<uint8_t> backbone_f, deleted;
  std::vector<std::vector<Edge>> out_e;
  std::vector<std::vector<REdge>> in_e;
  // Flat out-degrees: the merge scan reads these instead of chasing
  // per-node vector headers (the former dominated merge_nodes time).
  std::vector<int32_t> outdeg;
  std::vector<int32_t> kahn_remaining;  // reused scratch

  void ensure(int32_t cap) {
    int32_t cur = (int32_t)base.size();
    if (cur >= cap) return;
    int32_t nc = std::max(cap, cur + cur / 2 + 64);  // geometric growth
    base.resize(nc);
    weight.resize(nc);
    coverage.resize(nc);
    anchor.resize(nc);
    backbone_f.resize(nc);
    deleted.resize(nc);
    out_e.resize(nc);
    in_e.resize(nc);
    outdeg.resize(nc);
  }

  void init(const std::string& bb) {
    L = (int32_t)bb.size();
    enter = 0;
    exit = L + 1;
    n = L + 2;
    ensure(n);
    base[0] = '^';
    for (int32_t p = 0; p < L; ++p) base[p + 1] = (uint8_t)bb[p];
    base[L + 1] = '$';
    for (int32_t v = 0; v < n; ++v) {
      weight[v] = 1;
      coverage[v] = 0;
      backbone_f[v] = 1;
      anchor[v] = v;
      deleted[v] = 0;
      out_e[v].clear();  // keeps capacity
      in_e[v].clear();
      outdeg[v] = 0;
    }
    weight[0] = weight[L + 1] = 0;
    for (int32_t p = 0; p <= L; ++p) {
      out_e[p].push_back({p + 1, 0});
      in_e[p + 1].push_back({p, 0});
      outdeg[p] = 1;
    }
  }

  int32_t new_node(uint8_t b, int32_t anc) {
    int32_t v = n++;
    ensure(n);
    base[v] = b;
    weight[v] = 1;
    coverage[v] = 0;
    backbone_f[v] = 0;
    anchor[v] = anc;
    deleted[v] = 0;
    out_e[v].clear();
    in_e[v].clear();
    outdeg[v] = 0;
    return v;
  }

  void add_edge(int32_t u, int32_t v) {
    for (Edge& e : out_e[u]) {
      if (e.to == v) {
        ++e.count;
        for (REdge& r : in_e[v])
          if (r.from == u) {
            ++r.count;
            break;
          }
        return;
      }
    }
    out_e[u].push_back({v, 1});
    in_e[v].push_back({u, 1});
    ++outdeg[u];
  }

  // SPEC §2.4; alignment must be normalized.
  bool add_aln(const Alignment& a) {
    if (a.empty()) return true;
    int32_t tpos = a.start - 1;
    int32_t prev = enter;
    for (size_t i = 0; i < a.qstr.size(); ++i) {
      char qb = a.qstr[i], tb = a.tstr[i];
      if (qb != '-' && tb != '-') {
        ++tpos;
        if (tpos > L) return false;
        ++coverage[tpos];
        ++weight[tpos];
        add_edge(prev, tpos);
        prev = tpos;
      } else if (qb == '-') {
        ++tpos;
        if (tpos > L) return false;
        ++coverage[tpos];
      } else {
        int32_t v = new_node((uint8_t)qb, tpos);
        add_edge(prev, v);
        prev = v;
      }
    }
    add_edge(prev, exit);
    return true;
  }

  // SPEC §2.5 node merging. Kahn BFS from enter; per node, group
  // out-degree-1 in-neighbors by base (ascending), merge into the first,
  // recurse on the survivor.
  void merge_nodes() {
    std::vector<int32_t>& remaining = kahn_remaining;
    remaining.assign(n, 0);
    for (int32_t v = 0; v < n; ++v)
      if (!deleted[v]) remaining[v] = (int32_t)in_e[v].size();
    std::deque<int32_t> q;
    q.push_back(enter);
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop_front();
      merge_in_nodes(u);
      for (const Edge& e : out_e[u]) {
        if (--remaining[e.to] == 0) q.push_back(e.to);
      }
    }
  }

  // One depth-first merge frame: the snapshot of node `target`'s merge
  // groups (out-degree-1 in-neighbors grouped by base), flattened into
  // `nodes` with `off` group offsets, plus the next-group cursor `gi`.
  // Frames are pooled in `merge_frames` (vectors keep capacity) so
  // steady-state merging stays allocation-free.
  struct MergeFrame {
    int32_t target = -1;
    std::vector<int32_t> nodes;  // group members, flattened
    std::vector<int32_t> off;    // [ngroups+1] offsets into nodes
    size_t gi = 0;               // next group to process
    std::vector<int32_t> cand;   // scratch: candidates in in-edge order
    std::vector<uint8_t> cbase;  // scratch: their bases
    std::vector<uint8_t> dbase;  // scratch: distinct bases ascending
  };
  std::vector<MergeFrame> merge_frames;

  // Snapshot node n's merge groups into frame f (same order semantics as
  // the oracle: candidates in in-edge order, groups keyed by ascending
  // base, only groups of >= 2 kept).
  void fill_merge_frame(MergeFrame& f, int32_t n) {
    f.target = n;
    f.gi = 0;
    f.nodes.clear();
    f.off.assign(1, 0);
    f.cand.clear();
    f.cbase.clear();
    for (const REdge& r : in_e[n]) {
      if (outdeg[r.from] == 1) {
        f.cand.push_back(r.from);
        f.cbase.push_back(base[r.from]);
      }
    }
    if (f.cand.size() < 2) return;
    f.dbase.assign(f.cbase.begin(), f.cbase.end());
    std::sort(f.dbase.begin(), f.dbase.end());
    f.dbase.erase(std::unique(f.dbase.begin(), f.dbase.end()),
                  f.dbase.end());
    for (uint8_t bv : f.dbase) {
      size_t start = f.nodes.size();
      for (size_t i = 0; i < f.cand.size(); ++i)
        if (f.cbase[i] == bv) f.nodes.push_back(f.cand[i]);
      if (f.nodes.size() - start < 2)
        f.nodes.resize(start);  // singleton: nothing to merge
      else
        f.off.push_back((int32_t)f.nodes.size());
    }
  }

  // Iterative depth-first merge (explicit frame stack): pathological
  // merge chains (100-500x coverage pileups) must not overflow the call
  // stack. Order is bit-identical to the recursive form: per node,
  // groups are snapshotted up front and processed in ascending-base
  // order; after a group merges into its survivor `a`, a's own groups
  // are fully processed before this node's next group.
  void merge_in_nodes(int32_t n0) {
    if (merge_frames.empty()) merge_frames.emplace_back();
    fill_merge_frame(merge_frames[0], n0);
    size_t depth = 1;
    while (depth) {
      MergeFrame& f = merge_frames[depth - 1];
      if (f.gi + 1 >= f.off.size()) {
        --depth;
        continue;
      }
      const int32_t lo = f.off[f.gi];
      const int32_t hi = f.off[f.gi + 1];
      ++f.gi;
      const int32_t n = f.target;
      const int32_t a = f.nodes[lo];
      for (int32_t xi = lo + 1; xi < hi; ++xi) {
        int32_t x = merge_frames[depth - 1].nodes[xi];
        weight[a] += weight[x];
        // cx = count of x->n (key lookup, parity with the oracle).
        int32_t cx = 0;
        for (const Edge& e : out_e[x])
          if (e.to == n) {
            cx = e.count;
            break;
          }
        for (Edge& e : out_e[a])
          if (e.to == n) {
            e.count += cx;
            break;
          }
        for (REdge& r : in_e[n])
          if (r.from == a) {
            r.count += cx;
            break;
          }
        // Move x's in-edges to a (creation order).
        for (const REdge& rx : in_e[x]) {
          int32_t s = rx.from, c = rx.count;
          bool found = false;
          for (Edge& e : out_e[s])
            if (e.to == a) {
              e.count += c;
              found = true;
              break;
            }
          if (found) {
            for (REdge& r : in_e[a])
              if (r.from == s) {
                r.count += c;
                break;
              }
          } else {
            out_e[s].push_back({a, c});
            in_e[a].push_back({s, c});
            ++outdeg[s];
          }
          // Remove s->x from out_e[s], preserving order.
          for (size_t k = 0; k < out_e[s].size(); ++k)
            if (out_e[s][k].to == x) {
              out_e[s].erase(out_e[s].begin() + k);
              --outdeg[s];
              break;
            }
        }
        // Disconnect & delete x.
        out_e[x].clear();
        outdeg[x] = 0;
        for (size_t k = 0; k < in_e[n].size(); ++k)
          if (in_e[n][k].from == x) {
            in_e[n].erase(in_e[n].begin() + k);
            break;
          }
        in_e[x].clear();
        deleted[x] = 1;
      }
      // Descend into the survivor before this node's next group.
      if (depth == merge_frames.size()) merge_frames.emplace_back();
      fill_merge_frame(merge_frames[depth], a);
      ++depth;
    }
  }
};

// ------------------------------------------------------------- linearize

// Banded linearization (SPEC §3.1) in CSR form.
struct Linear {
  std::string sid;
  int32_t backbone_len = 0;
  int32_t n = 0;
  int32_t span = 0;
  std::vector<uint8_t> base;
  std::vector<int32_t> weight, bb, cov;
  std::vector<uint8_t> unsup;
  std::vector<int32_t> exit_count;  // -1 = none
  // Creation-order CSR out-edges; target == n means virtual exit.
  std::vector<int32_t> edge_off;  // [n+1]
  std::vector<int32_t> edge_tgt, edge_cnt;
  std::vector<int32_t> enter_tgt, enter_cnt;  // enter's out-edges
};

// Kahn topological order with min-heap keyed (anchor, is_insertion, id):
// backbone ascending, each gap's merged insertion trie between its
// flanking backbone nodes.
static bool linearize(const Graph& g, const std::string& sid, Linear& lin) {
  size_t n_all = (size_t)g.n;
  std::vector<int32_t> indeg(n_all, -1);
  size_t alive = 0;
  for (size_t v = 0; v < n_all; ++v) {
    if (!g.deleted[v]) {
      indeg[v] = (int32_t)g.in_e[v].size();
      ++alive;
    }
  }
  typedef std::tuple<int32_t, int32_t, int32_t> Key;  // anchor, ins, id
  std::priority_queue<Key, std::vector<Key>, std::greater<Key>> heap;
  heap.push(Key(g.anchor[g.enter], 0, g.enter));
  std::vector<int32_t> order;
  order.reserve(alive);
  while (!heap.empty()) {
    int32_t u = std::get<2>(heap.top());
    heap.pop();
    order.push_back(u);
    for (const Edge& e : g.out_e[u]) {
      if (--indeg[e.to] == 0)
        heap.push(Key(g.anchor[e.to], g.backbone_f[e.to] ? 0 : 1, e.to));
    }
  }
  if (order.size() != alive) return false;

  std::vector<int32_t> lin_of(n_all, -1);
  int32_t n = 0;
  for (int32_t v : order)
    if (v != g.enter && v != g.exit) lin_of[v] = n++;

  lin.sid = sid;
  lin.backbone_len = g.L;
  lin.n = n;
  lin.span = 0;
  lin.base.resize(n);
  lin.weight.resize(n);
  lin.bb.resize(n);
  lin.cov.resize(n);
  lin.unsup.resize(n);
  lin.exit_count.assign(n, -1);
  lin.edge_off.assign(n + 1, 0);
  lin.edge_tgt.clear();
  lin.edge_cnt.clear();
  lin.enter_tgt.clear();
  lin.enter_cnt.clear();

  int32_t i = 0;
  for (int32_t v : order) {
    if (v == g.enter || v == g.exit) continue;
    lin.base[i] = g.base[v];
    lin.weight[i] = g.weight[v];
    lin.bb[i] = g.backbone_f[v] ? v : 0;
    lin.cov[i] = g.coverage[g.anchor[v]];
    lin.unsup[i] = (g.backbone_f[v] && g.weight[v] == 1) ? 1 : 0;
    for (const Edge& e : g.out_e[v]) {
      if (e.to == g.exit) {
        lin.exit_count[i] = e.count;
        lin.edge_tgt.push_back(n);
        lin.edge_cnt.push_back(e.count);
      } else {
        int32_t j = lin_of[e.to];
        if (j <= i) return false;  // non-forward edge: internal error
        if (j - i > lin.span) lin.span = j - i;
        lin.edge_tgt.push_back(j);
        lin.edge_cnt.push_back(e.count);
      }
    }
    lin.edge_off[i + 1] = (int32_t)lin.edge_tgt.size();
    ++i;
  }
  // Keep a direct enter->exit edge (all-deletion records create one) as
  // a virtual candidate with target n (escore = count, score 0); when
  // strictly best the backtrack terminates immediately, matching the
  // oracle's best_path which scores this edge like any other.
  for (const Edge& e : g.out_e[g.enter]) {
    lin.enter_tgt.push_back(e.to == g.exit ? n : lin_of[e.to]);
    lin.enter_cnt.push_back(e.count);
  }
  return true;
}

// ------------------------------------------------- DP / backtrack / emit

static inline float escore(const Linear& lin, int32_t w, int32_t count) {
  if (w == lin.n) return (float)count;  // exit: weight 0, coverage 0
  if (lin.unsup[w]) return kPenalty;
  return (float)count - 0.5f * (float)lin.cov[w];
}

// Reference-exact float32 DP over the CSR arrays (SPEC §2.6).
static void host_scores(const Linear& lin, std::vector<float>& score) {
  score.assign(lin.n + 1, kNegMax);
  score[lin.n] = 0.0f;
  for (int32_t u = lin.n - 1; u >= 0; --u) {
    float best = kNegMax;
    for (int32_t e = lin.edge_off[u]; e < lin.edge_off[u + 1]; ++e) {
      float cand = escore(lin, lin.edge_tgt[e], lin.edge_cnt[e]) +
                   score[lin.edge_tgt[e]];
      if (cand > best) best = cand;
    }
    score[u] = best;
  }
}

// Creation-order first-strict-max walk from enter (SPEC §2.6 tie-break).
// `score` has n+1 entries (virtual exit last, = 0).
static void backtrack(const Linear& lin, const float* score,
                      std::vector<int32_t>& path) {
  path.clear();
  float best = kNegMax;
  int32_t u = -1;
  for (size_t k = 0; k < lin.enter_tgt.size(); ++k) {
    int32_t w = lin.enter_tgt[k];
    float cand = escore(lin, w, lin.enter_cnt[k]) + score[w];
    if (cand > best) {
      best = cand;
      u = w;
    }
  }
  while (u >= 0 && u != lin.n) {
    path.push_back(u);
    best = kNegMax;
    int32_t nxt = -1;
    for (int32_t e = lin.edge_off[u]; e < lin.edge_off[u + 1]; ++e) {
      int32_t w = lin.edge_tgt[e];
      float cand = escore(lin, w, lin.edge_cnt[e]) + score[w];
      if (cand > best) {
        best = cand;
        nxt = w;
      }
    }
    u = nxt;
  }
}

// Fragment emission (SPEC §2.7) as FASTA text appended to `out`.
static void emit_consensus(const Linear& lin, const std::vector<int32_t>& path,
                           int32_t min_weight, int32_t min_length,
                           std::string& out) {
  int32_t bb_pos = 0, kept_end = 0, range_start = 0;
  std::string frag;
  auto close = [&]() {
    if ((int32_t)frag.size() >= min_length && !frag.empty()) {
      char hdr[64];
      out += ">";
      out += lin.sid;
      snprintf(hdr, sizeof hdr, "/%d_%d\n", range_start, kept_end);
      out += hdr;
      out += frag;
      out += "\n";
    }
    frag.clear();
  };
  for (int32_t v : path) {
    bool is_bb = lin.bb[v] != 0;
    if (is_bb) bb_pos = lin.bb[v];
    if (lin.weight[v] >= min_weight) {
      if (frag.empty()) range_start = is_bb ? bb_pos - 1 : bb_pos;
      frag.push_back((char)lin.base[v]);
      kept_end = bb_pos;
    } else {
      close();
    }
  }
  close();
}

// ------------------------------------------------------------ engine

struct Group {
  std::string sid;
  std::vector<Alignment> alns;
};

// Recover the backbone by painting records into an N-filled buffer
// (SPEC note in alignment.py:backbone_from_group; SURVEY.md §3.1).
static std::string backbone_of(const Group& g) {
  if (g.alns.empty()) return "";
  int32_t tlen = g.alns[0].tlen;
  std::string bb(tlen, 'N');
  for (const Alignment& a : g.alns) {
    int32_t p = a.start - 1;
    for (char c : a.tstr) {
      if (c != '-') {
        if (p >= tlen) return "";  // malformed; caller drops group
        bb[p] = c;
        ++p;
      }
    }
  }
  return bb;
}

struct Engine {
  int32_t min_weight = 8, min_length = 500, trim = 0, threads = 4;
  int32_t align = 0;  // re-align raw seq pairs (reference `dagcon -a`)
  int32_t scorer = 0;  // 0 = simple (SPEC §1.5), 1 = affine (SPEC §1.6)
  AffineParams aff;
  long targets_done = 0;
  std::string pending_line;           // partial trailing line
  Group pending_group;                // trailing (possibly incomplete) group
  std::vector<Group> ready;           // complete groups awaiting processing
  std::vector<Linear> linears;        // results of linearize_text
  std::mutex linears_mu;              // guards `linears` (producer thread
                                      // appends while consumer reads/clears)
  std::string error;
  // Loud-failure accounting: records skipped (malformed / raw pair
  // without -a) and groups dropped (backbone recovery or build failed).
  std::atomic<long> dropped_records{0};
  std::atomic<long> dropped_groups{0};

  void feed(const char* text, size_t len, int fmt, bool flush) {
    std::string buf;
    if (!pending_line.empty()) {
      buf.swap(pending_line);
      buf.append(text, len);
      text = buf.data();
      len = buf.size();
    }
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      if (!nl) {
        if (!flush) {
          pending_line.assign(p, (size_t)(end - p));
          p = end;
          break;
        }
        nl = end;
      }
      if (nl > p) {
        Alignment a;
        bool ok = fmt == 0 ? parse_m5(p, nl, a) : parse_pre(p, nl, a);
        if (ok) {
          if (!pending_group.alns.empty() && a.sid != pending_group.sid) {
            ready.push_back(std::move(pending_group));
            pending_group = Group();
          }
          if (pending_group.alns.empty()) pending_group.sid = a.sid;
          pending_group.alns.push_back(std::move(a));
        } else if (nl > p + 1 || *p != '\r') {
          error = "malformed record";
          ++dropped_records;
        }
      }
      p = nl < end ? nl + 1 : end;
    }
    if (flush && !pending_group.alns.empty()) {
      ready.push_back(std::move(pending_group));
      pending_group = Group();
    }
  }

  // Per-thread reusable state: the graph and scratch buffers keep their
  // heap capacity across targets, so steady-state building is
  // allocation-free (this is the program's hot loop, SURVEY.md §3.1).
  struct Worker {
    Graph g;
    NormScratch ns;
    AlignScratch as;
    AffineScratch afs;
    Alignment a;
    std::string aq, at;
    std::vector<float> score;
    std::vector<int32_t> path;
  };

  // Build + merge + linearize one group.
  bool build_one(const Group& grp, Linear& lin, Worker& wk) {
    std::string bb = backbone_of(grp);
    if (bb.empty()) return false;
    Graph& g = wk.g;
    g.init(bb);
    for (const Alignment& src : grp.alns) {
      Alignment& a = wk.a;
      a = src;
      if (align) {
        if (scorer == 1)
          align_pair_affine(a.qstr, a.tstr, wk.aq, wk.at, wk.afs, aff);
        else
          align_pair(a.qstr, a.tstr, wk.aq, wk.at, wk.as);
        a.qstr.swap(wk.aq);
        a.tstr.swap(wk.at);
        a.recompute_end();
      } else if (a.qstr.size() != a.tstr.size()) {
        ++dropped_records;  // raw pair without -a: skip record (counted)
        continue;
      }
      if (trim > 0) trim_aln(a, trim);
      normalize_gaps(a, wk.ns);
      if (!a.empty()) {
        if (!g.add_aln(a)) return false;
      }
    }
    g.merge_nodes();
    return linearize(g, grp.sid, lin);
  }

  // Parallel map over ready groups with `fn(group_idx, worker)`.
  template <typename F>
  void parallel_groups(size_t count, F fn) {
    int nthreads = std::max(1, std::min<int>(threads, (int)count));
    if (nthreads <= 1) {
      Worker wk;
      for (size_t i = 0; i < count; ++i) fn(i, wk);
      return;
    }
    std::atomic<size_t> next(0);
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&]() {
        Worker wk;
        for (;;) {
          size_t i = next.fetch_add(1);
          if (i >= count) return;
          fn(i, wk);
        }
      });
    }
    for (auto& th : pool) th.join();
  }

  // Host mode: consensus for all ready groups; FASTA in input order.
  void consensus_all(std::string& out) {
    size_t count = ready.size();
    std::vector<std::string> results(count);
    parallel_groups(count, [&](size_t i, Worker& wk) {
      Linear lin;
      if (!build_one(ready[i], lin, wk)) {
        ++dropped_groups;
        return;
      }
      host_scores(lin, wk.score);
      backtrack(lin, wk.score.data(), wk.path);
      emit_consensus(lin, wk.path, min_weight, min_length, results[i]);
    });
    for (const std::string& r : results) out += r;
    targets_done += (long)count;
    ready.clear();
  }

  // Loader mode: linearize all ready groups, APPENDING to the
  // retained list (callers clear explicitly). Retention lets the
  // pipeline overlap host linearization of the next chunk with device
  // DP + emission of the previous one. Returns #appended.
  int linearize_all() {
    size_t count = ready.size();
    std::vector<Linear> built(count);
    std::vector<uint8_t> ok(count, 0);
    parallel_groups(count, [&](size_t i, Worker& wk) {
      ok[i] = build_one(ready[i], built[i], wk) ? 1 : 0;
      if (!ok[i]) ++dropped_groups;
    });
    // Splice successes into the retained list under the lock.
    std::lock_guard<std::mutex> lk(linears_mu);
    size_t appended = 0;
    for (size_t i = 0; i < count; ++i) {
      if (ok[i]) {
        linears.push_back(std::move(built[i]));
        ++appended;
      }
    }
    ready.clear();
    return (int)appended;
  }

  // Release exported targets with index < upto (shrinks from the front).
  void clear_linears(int upto) {
    if (upto <= 0) return;
    std::lock_guard<std::mutex> lk(linears_mu);
    size_t u = std::min(linears.size(), (size_t)upto);
    linears.erase(linears.begin(), linears.begin() + u);
  }

  // ---- device-build encode mode -------------------------------------
  // Encoded pileup (the devbuild wire format): per read the normalized
  // column ops (1=M, 2=D, 3=I) and the inserted bases in column order.
  // The raw group is retained alongside so flagged targets can run the
  // exact host consensus (build_one path) without re-parsing.
  struct EncRead {
    int32_t start;
    std::string ops;
    std::string ins;
  };
  struct EncTarget {
    std::string sid;
    std::string bb;
    std::vector<EncRead> reads;
    Group group;  // retained for exact host fallback
  };
  std::vector<EncTarget> encoded;  // guarded by linears_mu

  bool encode_one(const Group& grp, EncTarget& et, Worker& wk) {
    et.sid = grp.sid;
    et.bb = backbone_of(grp);
    if (et.bb.empty()) return false;
    et.reads.clear();
    for (const Alignment& src : grp.alns) {
      Alignment& a = wk.a;
      a = src;
      if (align) {
        if (scorer == 1)
          align_pair_affine(a.qstr, a.tstr, wk.aq, wk.at, wk.afs, aff);
        else
          align_pair(a.qstr, a.tstr, wk.aq, wk.at, wk.as);
        a.qstr.swap(wk.aq);
        a.tstr.swap(wk.at);
        a.recompute_end();
      } else if (a.qstr.size() != a.tstr.size()) {
        ++dropped_records;
        continue;
      }
      if (trim > 0) trim_aln(a, trim);
      normalize_gaps(a, wk.ns);
      if (a.qstr.empty()) continue;
      EncRead er;
      er.start = a.start;
      er.ops.resize(a.qstr.size());
      for (size_t i = 0; i < a.qstr.size(); ++i) {
        char q = a.qstr[i], t = a.tstr[i];
        if (q != '-' && t != '-') {
          er.ops[i] = 1;
        } else if (q == '-') {
          er.ops[i] = 2;
        } else {
          er.ops[i] = 3;
          er.ins.push_back(q);
        }
      }
      et.reads.push_back(std::move(er));
    }
    return true;
  }

  int encode_all() {
    size_t count = ready.size();
    std::vector<EncTarget> built(count);
    std::vector<uint8_t> ok(count, 0);
    // Keep the group for fallback (copy before workers consume).
    for (size_t i = 0; i < count; ++i) built[i].group = ready[i];
    parallel_groups(count, [&](size_t i, Worker& wk) {
      ok[i] = encode_one(built[i].group, built[i], wk) ? 1 : 0;
      if (!ok[i]) ++dropped_groups;
    });
    std::lock_guard<std::mutex> lk(linears_mu);
    size_t appended = 0;
    for (size_t i = 0; i < count; ++i) {
      if (ok[i]) {
        encoded.push_back(std::move(built[i]));
        ++appended;
      }
    }
    ready.clear();
    return (int)appended;
  }

  void clear_encoded(int upto) {
    if (upto <= 0) return;
    std::lock_guard<std::mutex> lk(linears_mu);
    size_t u = std::min(encoded.size(), (size_t)upto);
    encoded.erase(encoded.begin(), encoded.begin() + u);
  }
};

}  // namespace dagcon

// ---------------------------------------------------------------- C ABI

extern "C" {

using dagcon::Engine;
using dagcon::Linear;

void* dagcon_engine_new(int min_weight, int min_length, int trim,
                        int threads) {
  Engine* e = new Engine();
  e->min_weight = min_weight;
  e->min_length = min_length;
  e->trim = trim;
  e->threads = threads;
  return e;
}

void dagcon_engine_free(void* h) { delete (Engine*)h; }

// Host mode: feed target-sorted text (fmt 0=m5, 1=pre); returns FASTA for
// complete groups via out/out_len (caller frees with dagcon_free).
int dagcon_consensus_text(void* h, const char* text, long len, int fmt,
                          int flush, char** out, long* out_len) {
  Engine* e = (Engine*)h;
  e->feed(text, (size_t)len, fmt, flush != 0);
  std::string fasta;
  e->consensus_all(fasta);
  char* buf = (char*)malloc(fasta.size() + 1);
  memcpy(buf, fasta.data(), fasta.size());
  buf[fasta.size()] = 0;
  *out = buf;
  *out_len = (long)fasta.size();
  return e->error.empty() ? 0 : 1;
}

void dagcon_free(char* p) { free(p); }

// Loader mode: parse + build + merge + linearize complete groups.
// Appends to the retained target list; returns the number APPENDED.
// Target indices are positions in the retained list; use
// dagcon_clear_linears to release emitted targets from the front
// (subsequent indices shift down).
int dagcon_linearize_text(void* h, const char* text, long len, int fmt,
                          int flush) {
  Engine* e = (Engine*)h;
  e->feed(text, (size_t)len, fmt, flush != 0);
  return e->linearize_all();
}

// Drop the first `upto` retained targets (after emission).
void dagcon_clear_linears(void* h, int upto) {
  ((Engine*)h)->clear_linears(upto);
}

// Loud-failure status: fills dropped record/group counters; returns 1 if
// a parse error was recorded (same condition dagcon_consensus_text
// reports), else 0. Lets loader-mode callers surface errors too.
int dagcon_engine_status(void* h, long* dropped_records,
                         long* dropped_groups) {
  Engine* e = (Engine*)h;
  if (dropped_records) *dropped_records = e->dropped_records.load();
  if (dropped_groups) *dropped_groups = e->dropped_groups.load();
  return e->error.empty() ? 0 : 1;
}

// meta[0]=n, meta[1]=span, meta[2]=n_edges, meta[3]=n_enter,
// meta[4]=backbone_len. Returns sid length (or -1 on bad idx).
int dagcon_target_meta(void* h, int idx, int* meta, char* sid_buf,
                       int sid_cap) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->linears.size()) return -1;
  const Linear& l = e->linears[idx];
  meta[0] = l.n;
  meta[1] = l.span;
  meta[2] = (int)l.edge_tgt.size();
  meta[3] = (int)l.enter_tgt.size();
  meta[4] = l.backbone_len;
  int sl = (int)l.sid.size();
  if (sid_buf && sid_cap > 0) {
    int c = std::min(sl, sid_cap - 1);
    memcpy(sid_buf, l.sid.data(), (size_t)c);
    sid_buf[c] = 0;
  }
  return sl;
}

// Fill caller-allocated arrays sized from dagcon_target_meta.
int dagcon_target_arrays(void* h, int idx, uint8_t* base, int32_t* weight,
                         int32_t* bb, int32_t* cov, uint8_t* unsup,
                         int32_t* exit_count, int32_t* edge_off,
                         int32_t* edge_tgt, int32_t* edge_cnt,
                         int32_t* enter_tgt, int32_t* enter_cnt) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->linears.size()) return -1;
  const Linear& l = e->linears[idx];
  memcpy(base, l.base.data(), l.base.size());
  memcpy(weight, l.weight.data(), l.weight.size() * 4);
  memcpy(bb, l.bb.data(), l.bb.size() * 4);
  memcpy(cov, l.cov.data(), l.cov.size() * 4);
  memcpy(unsup, l.unsup.data(), l.unsup.size());
  memcpy(exit_count, l.exit_count.data(), l.exit_count.size() * 4);
  memcpy(edge_off, l.edge_off.data(), l.edge_off.size() * 4);
  memcpy(edge_tgt, l.edge_tgt.data(), l.edge_tgt.size() * 4);
  memcpy(edge_cnt, l.edge_cnt.data(), l.edge_cnt.size() * 4);
  memcpy(enter_tgt, l.enter_tgt.data(), l.enter_tgt.size() * 4);
  memcpy(enter_cnt, l.enter_cnt.data(), l.enter_cnt.size() * 4);
  return 0;
}

// Exact backtrack + emission for target idx given scores[n+1] (virtual
// exit score last; device- or host-computed). FASTA via out/out_len.
int dagcon_target_consensus(void* h, int idx, const float* scores,
                            int min_weight, int min_length, char** out,
                            long* out_len) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->linears.size()) return -1;
  const Linear& l = e->linears[idx];
  std::vector<int32_t> path;
  dagcon::backtrack(l, scores, path);
  std::string fasta;
  dagcon::emit_consensus(l, path, min_weight, min_length, fasta);
  char* buf = (char*)malloc(fasta.size() + 1);
  memcpy(buf, fasta.data(), fasta.size());
  buf[fasta.size()] = 0;
  *out = buf;
  *out_len = (long)fasta.size();
  return 0;
}

// Total complete target groups consumed so far (host-mode stats).
long dagcon_engine_targets(void* h) { return ((Engine*)h)->targets_done; }

// Pack a bucket batch in EDGE-CSR form (the band tensor is ~95% empty;
// CSR cuts the host->device upload ~10x). Streams are caller-allocated:
//   eoff [B+1] i32; ue [E] i16; de [E] u8; ce [E] i16   (band edges)
//   xoff [B+1] i32; xu [X] i16; xc [X] i16              (exit edges)
//   cov [B,V] i16; unsup [B,V] u8 (dense)
//   long_u/long_w [B,K] i32; long_esc [B,K] f32
// Returns 0, or b+1 if target b cannot fit (n>V, >K long, cov>int16,
// E/X capacity exceeded -> -1).
int dagcon_pack_edges(void* h, const int32_t* idxs, int nidx, int V, int W,
                      int K, long E_cap, long X_cap, int32_t* eoff,
                      int16_t* ue, uint8_t* de, int16_t* ce, int32_t* xoff,
                      int16_t* xu, int16_t* xc, int16_t* cov, uint8_t* unsup,
                      int32_t* long_u, int32_t* long_w, float* long_esc) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  // Pass 1 (serial): per-target offsets.
  long etot = 0, xtot = 0;
  for (int b = 0; b < nidx; ++b) {
    eoff[b] = (int32_t)etot;
    xoff[b] = (int32_t)xtot;
    int idx = idxs[b];
    if (idx < 0 || idx >= (int)e->linears.size()) return b + 1;
    const Linear& l = e->linears[idx];
    if (l.n > V) return b + 1;
    long nb = 0, nx = 0, nk = 0;
    for (int32_t u = 0; u < l.n; ++u) {
      // int16 wire guards: edge counts can exceed per-column coverage
      // (merged boundary insertion nodes accumulate votes from every
      // read in the pileup), so check the counts, not just cov.
      if (l.cov[u] > 32000) return b + 1;
      for (int32_t ei = l.edge_off[u]; ei < l.edge_off[u + 1]; ++ei) {
        int32_t w = l.edge_tgt[ei];
        if (l.edge_cnt[ei] > 32000 && (w >= l.n || w - u - 1 < W))
          return b + 1;
        if (w >= l.n) {
          ++nx;
        } else if (w - u - 1 < W) {
          ++nb;
        } else {
          if (++nk > K) return b + 1;
        }
      }
    }
    etot += nb;
    xtot += nx;
    if (etot > E_cap || xtot > X_cap) return -1;
  }
  eoff[nidx] = (int32_t)etot;
  xoff[nidx] = (int32_t)xtot;
  // Pass 2 (threaded): fill streams + dense arrays.
  std::atomic<int> bad(0);
  e->parallel_groups((size_t)nidx, [&](size_t b, Engine::Worker&) {
    const Linear& l = e->linears[idxs[b]];
    int16_t* cb = cov + b * (size_t)V;
    uint8_t* ub = unsup + b * (size_t)V;
    memset(cb, 0, (size_t)V * 2);
    memset(ub, 0, (size_t)V);
    int32_t* lub = long_u + b * (size_t)K;
    int32_t* lwb = long_w + b * (size_t)K;
    float* leb = long_esc + b * (size_t)K;
    for (int k = 0; k < K; ++k) {
      lub[k] = -1;
      lwb[k] = -1;
      leb[k] = -__builtin_inff();
    }
    long ep = eoff[b], xp = xoff[b];
    int nk = 0;
    for (int32_t u = 0; u < l.n; ++u) {
      cb[u] = (int16_t)l.cov[u];
      ub[u] = l.unsup[u];
      for (int32_t ei = l.edge_off[u]; ei < l.edge_off[u + 1]; ++ei) {
        int32_t w = l.edge_tgt[ei];
        int32_t c = l.edge_cnt[ei];
        if (w >= l.n) {
          xu[xp] = (int16_t)u;
          xc[xp] = (int16_t)c;
          ++xp;
        } else if (w - u - 1 < W) {
          ue[ep] = (int16_t)u;
          de[ep] = (uint8_t)(w - u - 1);
          ce[ep] = (int16_t)c;
          ++ep;
        } else {
          lub[nk] = u;
          lwb[nk] = w;
          leb[nk] = escore(l, w, c);
          ++nk;
        }
      }
    }
  });
  return bad.load();
}

// Enable/disable re-alignment of raw pairs (reference `dagcon -a`).
void dagcon_engine_set_align(void* h, int align) {
  ((Engine*)h)->align = align;
}

// Standalone pairwise alignment (SPEC §1.5) for tests/tools: returns a
// malloc'd buffer "qstr\ntstr" (caller frees with dagcon_free).
int dagcon_align_pair(const char* q, long ql, const char* t, long tl,
                      char** out, long* out_len) {
  dagcon::AlignScratch as;
  std::string qs, ts;
  dagcon::align_pair(std::string(q, (size_t)ql), std::string(t, (size_t)tl),
                     qs, ts, as);
  std::string res = qs + "\n" + ts;
  char* buf = (char*)malloc(res.size() + 1);
  memcpy(buf, res.data(), res.size());
  buf[res.size()] = 0;
  *out = buf;
  *out_len = (long)res.size();
  return 0;
}

// Select the -a scorer: 0 = simple linear-gap DP (SPEC §1.5, default),
// 1 = affine Gotoh (SPEC §1.6) with (match, mismatch, open, extend).
void dagcon_engine_set_scorer(void* h, int scorer, int match, int mismatch,
                              int open_, int extend_) {
  Engine* e = (Engine*)h;
  e->scorer = scorer;
  e->aff.match = match;
  e->aff.mismatch = mismatch;
  e->aff.open = open_;
  e->aff.extend = extend_;
}

// Standalone affine pairwise alignment (SPEC §1.6) for tests/tools.
int dagcon_align_pair_affine(const char* q, long ql, const char* t, long tl,
                             int match, int mismatch, int open_, int extend_,
                             char** out, long* out_len) {
  dagcon::AffineScratch as;
  dagcon::AffineParams pp;
  pp.match = match;
  pp.mismatch = mismatch;
  pp.open = open_;
  pp.extend = extend_;
  std::string qs, ts;
  dagcon::align_pair_affine(std::string(q, (size_t)ql),
                            std::string(t, (size_t)tl), qs, ts, as, pp);
  std::string res = qs + "\n" + ts;
  char* buf = (char*)malloc(res.size() + 1);
  memcpy(buf, res.data(), res.size());
  buf[res.size()] = 0;
  *out = buf;
  *out_len = (long)res.size();
  return 0;
}

// Per-target long-edge counts: out[k] = #interior edges with span > Ws[k].
int dagcon_long_counts(void* h, int idx, const int32_t* Ws, int nW,
                       int32_t* out) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->linears.size()) return -1;
  const Linear& l = e->linears[idx];
  for (int k = 0; k < nW; ++k) out[k] = 0;
  for (int32_t u = 0; u < l.n; ++u) {
    for (int32_t ei = l.edge_off[u]; ei < l.edge_off[u + 1]; ++ei) {
      int32_t w = l.edge_tgt[ei];
      if (w >= l.n) continue;
      int32_t span = w - u;
      for (int k = 0; k < nW; ++k)
        if (span > Ws[k]) ++out[k];
    }
  }
  return 0;
}

// Pack a bucket batch for the device DP (the host side of SPEC §3.2's
// padded arrays), threaded over targets. Buffers are caller-allocated:
//   win [B,V,W] i16 (-1 pad), exit/cov [B,V] i16, unsup [B,V] u8,
//   long_u/long_w [B,K] i32 (-1 pad), long_esc [B,K] f32 (-inf pad).
// Returns 0, or b+1 if target b cannot fit (n>V, >K long edges, or
// coverage beyond int16) — caller falls back.
int dagcon_pack_batch(void* h, const int32_t* idxs, int nidx, int V, int W,
                      int K, int16_t* win, int16_t* exit_c, int16_t* cov,
                      uint8_t* unsup, int32_t* long_u, int32_t* long_w,
                      float* long_esc) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  std::atomic<int> bad(0);
  e->parallel_groups((size_t)nidx, [&](size_t b, Engine::Worker&) {
    int idx = idxs[b];
    if (idx < 0 || idx >= (int)e->linears.size()) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    const Linear& l = e->linears[idx];
    int16_t* wb = win + b * (size_t)V * W;
    int16_t* eb = exit_c + b * (size_t)V;
    int16_t* cb = cov + b * (size_t)V;
    uint8_t* ub = unsup + b * (size_t)V;
    int32_t* lub = long_u + b * (size_t)K;
    int32_t* lwb = long_w + b * (size_t)K;
    float* leb = long_esc + b * (size_t)K;
    for (size_t i = 0; i < (size_t)V * W; ++i) wb[i] = -1;
    for (int i = 0; i < V; ++i) eb[i] = -1;
    memset(cb, 0, (size_t)V * 2);
    memset(ub, 0, (size_t)V);
    for (int k = 0; k < K; ++k) {
      lub[k] = -1;
      lwb[k] = -1;
      leb[k] = -__builtin_inff();
    }
    if (l.n > V) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    int nk = 0;
    for (int32_t u = 0; u < l.n; ++u) {
      // int16 wire guards (see dagcon_pack_edges): counts as well as cov.
      if (l.cov[u] > 32000 || l.exit_count[u] > 32000) {
        int exp = 0;
        bad.compare_exchange_strong(exp, (int)b + 1);
        return;
      }
      eb[u] = (int16_t)l.exit_count[u];
      cb[u] = (int16_t)l.cov[u];
      ub[u] = l.unsup[u];
      for (int32_t ei = l.edge_off[u]; ei < l.edge_off[u + 1]; ++ei) {
        int32_t w = l.edge_tgt[ei];
        if (w >= l.n) continue;
        int32_t d = w - u - 1;
        if (d < W) {
          if (l.edge_cnt[ei] > 32000) {
            int exp = 0;
            bad.compare_exchange_strong(exp, (int)b + 1);
            return;
          }
          wb[(size_t)u * W + d] = (int16_t)l.edge_cnt[ei];
        } else {
          if (nk >= K) {
            int exp = 0;
            bad.compare_exchange_strong(exp, (int)b + 1);
            return;
          }
          lub[nk] = u;
          lwb[nk] = w;
          leb[nk] = escore(l, w, l.edge_cnt[ei]);
          ++nk;
        }
      }
    }
  });
  return bad.load();
}

// ---- device-build encode mode --------------------------------------
// Parse + normalize + encode complete groups (no graph build; the
// build runs on the accelerator). Appends to the retained encoded list;
// returns the number appended, or -1 on malformed input.
int dagcon_encode_text(void* h, const char* text, long len, int fmt,
                       int flush) {
  Engine* e = (Engine*)h;
  e->feed(text, (size_t)len, fmt, flush != 0);
  int n = e->encode_all();
  return e->error.empty() ? n : -1;
}

// meta[0]=R (#reads), meta[1]=max columns, meta[2]=backbone len,
// meta[3]=total inserted bases, meta[4]=total columns,
// meta[5]=max insertion chains per read (device CH requirement),
// meta[6]=max chain length (insertions in one inter-match segment;
// device SM requirement),
// meta[7]=max interior transition span (consecutive-match target-pos
// gap with no interposed insertion; device DQ requirement),
// meta[8]=max chains starting at one anchor, incl. the p=0 enter row
// (upper bound on start edges per position; device SE requirement —
// dedupe by (p, deepest node) can only shrink it).
// Returns sid length or -1.
int dagcon_enc_meta(void* h, int idx, int* meta, char* sid_buf,
                    int sid_cap) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->encoded.size()) return -1;
  const Engine::EncTarget& t = e->encoded[idx];
  size_t maxc = 0, ni = 0, totc = 0;
  int max_ch = 0, max_run = 0, max_dq = 0, max_se = 0;
  std::vector<int> anchor_cnt(t.bb.size() + 2, 0);
  for (const auto& r : t.reads) {
    maxc = std::max(maxc, r.ops.size());
    ni += r.ins.size();
    totc += r.ops.size();
    // Chains mirror the device build (ops/devbuild_jax.py
    // extract_chains): one chain per inter-match segment that holds
    // >=1 insertion; its length is the segment's insertion count.
    int seg = 0, cur_seg = -1, cur_len = 0, nch = 0;
    int tpos = r.start - 1, prev_m = -1;
    bool seg_ins = false;
    for (char op : r.ops) {
      if (op == 1) {
        ++seg;
        ++tpos;
        if (prev_m >= 1 && !seg_ins && tpos - prev_m > max_dq)
          max_dq = tpos - prev_m;
        prev_m = tpos;
        seg_ins = false;
      } else if (op == 2) {
        ++tpos;
      } else if (op == 3) {
        if (!seg_ins) {
          int p = prev_m >= 1 ? prev_m : 0;
          if (p < (int)anchor_cnt.size() && ++anchor_cnt[p] > max_se)
            max_se = anchor_cnt[p];
        }
        seg_ins = true;
        if (seg != cur_seg) {
          cur_seg = seg;
          ++nch;
          cur_len = 0;
        }
        if (++cur_len > max_run) max_run = cur_len;
      }
    }
    if (nch > max_ch) max_ch = nch;
  }
  meta[0] = (int)t.reads.size();
  meta[1] = (int)maxc;
  meta[2] = (int)t.bb.size();
  meta[3] = (int)ni;
  meta[4] = (int)totc;
  meta[5] = max_ch;
  meta[6] = max_run;
  meta[7] = max_dq;
  meta[8] = max_se;
  int sl = (int)t.sid.size();
  if (sid_buf && sid_cap > 0) {
    int c = std::min(sl, sid_cap - 1);
    memcpy(sid_buf, t.sid.data(), (size_t)c);
    sid_buf[c] = 0;
  }
  return sl;
}

// Fill the batched device-build input arrays for targets `idxs` (all
// arrays caller-allocated and zeroed): ops [n, R, C] u8, starts [n, R]
// i32, bb [n, L] u8, ins [n, NI] u8, Lr [n] i32. Returns 0, or b+1 if
// target b exceeds a cap.
int dagcon_enc_fill(void* h, const int32_t* idxs, int nidx, int R, int C,
                    int L, long NI, uint8_t* ops, int32_t* starts,
                    uint8_t* bb, uint8_t* ins, int32_t* Lr) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  std::atomic<int> bad(0);
  e->parallel_groups((size_t)nidx, [&](size_t b, Engine::Worker&) {
    int idx = idxs[b];
    if (idx < 0 || idx >= (int)e->encoded.size()) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    const Engine::EncTarget& t = e->encoded[idx];
    if ((int)t.reads.size() > R || (int)t.bb.size() > L) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    uint8_t* ob = ops + b * (size_t)R * C;
    int32_t* sb = starts + b * (size_t)R;
    uint8_t* bbp = bb + b * (size_t)L;
    uint8_t* ib = ins + b * (size_t)NI;
    memcpy(bbp, t.bb.data(), t.bb.size());
    Lr[b] = (int32_t)t.bb.size();
    long ni = 0;
    for (size_t r = 0; r < t.reads.size(); ++r) {
      const auto& rd = t.reads[r];
      if ((int)rd.ops.size() > C ||
          ni + (long)rd.ins.size() > NI) {
        int exp = 0;
        bad.compare_exchange_strong(exp, (int)b + 1);
        return;
      }
      sb[r] = rd.start;
      memcpy(ob + r * (size_t)C, rd.ops.data(), rd.ops.size());
      memcpy(ib + ni, rd.ins.data(), rd.ins.size());
      ni += (long)rd.ins.size();
    }
  });
  return bad.load();
}

// Packed variant of dagcon_enc_fill: ops codes are 2-bit ({PAD, MATCH,
// DEL, INS} = 0..3), so four columns pack into one byte (col 4k in bits
// 0-1 of byte k). `opsp` is [n, R, C/4] (C must be a multiple of 4);
// every other array matches dagcon_enc_fill. Quarters the dominant
// upload through the host<->device link; the device unpacks with two
// vector ops inside the build program.
int dagcon_enc_fill_packed(void* h, const int32_t* idxs, int nidx, int R,
                           int C, int L, long NI, uint8_t* opsp,
                           int32_t* starts, uint8_t* bb, uint8_t* ins,
                           int32_t* Lr) {
  if (C % 4 != 0) return -1;
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  std::atomic<int> bad(0);
  int C4 = C >> 2;
  e->parallel_groups((size_t)nidx, [&](size_t b, Engine::Worker&) {
    int idx = idxs[b];
    if (idx < 0 || idx >= (int)e->encoded.size()) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    const Engine::EncTarget& t = e->encoded[idx];
    if ((int)t.reads.size() > R || (int)t.bb.size() > L) {
      int exp = 0;
      bad.compare_exchange_strong(exp, (int)b + 1);
      return;
    }
    uint8_t* ob = opsp + b * (size_t)R * C4;
    int32_t* sb = starts + b * (size_t)R;
    uint8_t* bbp = bb + b * (size_t)L;
    uint8_t* ib = ins + b * (size_t)NI;
    memcpy(bbp, t.bb.data(), t.bb.size());
    Lr[b] = (int32_t)t.bb.size();
    long ni = 0;
    for (size_t r = 0; r < t.reads.size(); ++r) {
      const auto& rd = t.reads[r];
      if ((int)rd.ops.size() > C || ni + (long)rd.ins.size() > NI) {
        int exp = 0;
        bad.compare_exchange_strong(exp, (int)b + 1);
        return;
      }
      sb[r] = rd.start;
      const uint8_t* src = (const uint8_t*)rd.ops.data();
      size_t m = rd.ops.size();
      uint8_t* dst = ob + r * (size_t)C4;
      size_t k = 0;
      for (; k + 4 <= m; k += 4)
        dst[k >> 2] = (uint8_t)(src[k] | (src[k + 1] << 2) |
                                (src[k + 2] << 4) | (src[k + 3] << 6));
      if (k < m) {
        uint8_t v = 0;
        for (size_t j = k; j < m; ++j)
          v = (uint8_t)(v | (src[j] << ((j - k) * 2)));
        dst[k >> 2] = v;  // tail bytes beyond m stay 0 = PAD
      }
      memcpy(ib + ni, rd.ins.data(), rd.ins.size());
      ni += (long)rd.ins.size();
    }
  });
  return bad.load();
}

void dagcon_enc_clear(void* h, int upto) {
  ((Engine*)h)->clear_encoded(upto);
}

// Exact host consensus for one encoded target (flagged-target
// fallback): full native build + DP + backtrack + FASTA emission.
int dagcon_enc_consensus(void* h, int idx, char** out, long* out_len) {
  Engine* e = (Engine*)h;
  Engine::Worker wk;
  std::string fasta;
  {
    std::lock_guard<std::mutex> lk(e->linears_mu);
    if (idx < 0 || idx >= (int)e->encoded.size()) return -1;
    Linear lin;
    if (e->build_one(e->encoded[idx].group, lin, wk)) {
      dagcon::host_scores(lin, wk.score);
      dagcon::backtrack(lin, wk.score.data(), wk.path);
      dagcon::emit_consensus(lin, wk.path, e->min_weight, e->min_length,
                             fasta);
    }
  }
  char* buf = (char*)malloc(fasta.size() + 1);
  memcpy(buf, fasta.data(), fasta.size());
  buf[fasta.size()] = 0;
  *out = buf;
  *out_len = (long)fasta.size();
  return 0;
}

// Host-side float32 DP for target idx: fills scores[n+1].
int dagcon_target_scores(void* h, int idx, float* scores) {
  Engine* e = (Engine*)h;
  std::lock_guard<std::mutex> lk(e->linears_mu);
  if (idx < 0 || idx >= (int)e->linears.size()) return -1;
  std::vector<float> s;
  dagcon::host_scores(e->linears[idx], s);
  memcpy(scores, s.data(), s.size() * 4);
  return 0;
}

}  // extern "C"
