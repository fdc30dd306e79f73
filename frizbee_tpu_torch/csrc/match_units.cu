// Row-major fused prefilter + Smith-Waterman for Hopper (sm_90a): needles
// of up to 64 units, typo budgets of up to 8, byte rows and codepoint
// (unicode) rows.
//
// Replaces the Pallas kernel frizbee_tpu/ops/kernels.py match_units (body
// _match_tile), both of its unit branches. There lanes are a row's unit
// columns and the gap recurrence is a log2(W) max-plus lane scan; here one
// thread owns one row and walks its columns, so every DP dependency is a
// loop-carried register, as in colstream_fuzzy.cu, whose semantics this
// kernel shares (the colstream kernel is pinned equal to _match_tile).
//
// Rows stay in the bucket's (B, W) row-major layout. Logical row i of
// query q is bucket row rows[q*B + i] (identity without rows): the
// serving flow sorts each query's stage-1 survivors to the front and
// passes their count in scalars[q, 0], so whole blocks past the count
// exit at once and the work scales with the survivors. Grid = (row blocks,
// Q), one launch per bucket for every query.
//
// A thread reading its own row straight from device memory would stride
// by the row across the warp, so each block first stages its rows in
// shared memory with coalesced 4-byte loads (rows padded to an odd number
// of words, so the threads' word reads fall in distinct banks). Byte rows:
// blocks hold 32768 / W rows (32..128), 32 KB of rows. Codepoint rows take
// 4 bytes a unit, and a block never holds fewer than the 32 rows of one
// warp, so a w512 or w1024 block stages 64 or 128 KB: the launch opts the
// kernel into that much dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize; 227 KB per block on H100)
// rather than staging fewer rows.
//
// The needle arrives as 64-bit unit masks per value (the units a value
// matches, orig or flip; the units whose original case it equals), so the
// T=0 greedy embedding and the T+1-state minimal-position DP cost O(T) per
// column, not O(n*T), and the DP's per-unit match bits are bit tests of one
// register pair. Bytes index two 256-entry tables. Codepoints look up a
// 256-slot open-addressing hash table in shared memory holding the
// needle's <= 128 distinct orig/flip values: each value's masks are built
// by the thread that inserts it (one thread per needle value, atomicCAS on
// the key), so a lookup equals ``c == orig[k] || c == flip[k]`` bit for
// bit, and a value outside the needle ends its probe at an empty slot.
// h[k] lives in registers; the kernel is templated on a ceiling NMAX in
// {16, 32, 64} with the needle length n at run time.
//
// A codepoint row's window and end_col are UTF-8 byte offsets: each column
// derives its lead and last byte and length from the codepoint (as
// _unit_context does) and the walk carries the byte offset; the DP walks
// from column 0 to the first unit at or past the window's start byte.
//
// As in _match_tile, rows the prefilter rejects still run the DP over the
// full row in columns mode (their score, exact and end_col are part of the
// (B, 8) result); key-emit mode writes their sentinel without it.
//
// Bound on this card: integer ALU work, ~14 int32 operations per (column,
// needle unit) cell of each matched row's window plus ~6 + 3(T+1) per
// column of every live row's prefilter, against W bytes (4W for
// codepoints) per live row.

#include "kernel_common.cuh"

namespace {

using frizbee::byte_ctx;
using frizbee::codepoint_ctx;
using frizbee::context_bonus;
using frizbee::ctx_blen;
using frizbee::kKeySentinel;
using frizbee::kMaxHaystackLen;
using frizbee::kMaxNeedle;
using frizbee::kScalars;
using frizbee::Scoring;

constexpr int kMaxThreads = 128;
constexpr int kMaxTypos = 8;
constexpr int kStageBytes = 32768;
constexpr int kHashSlots = 256;  // > 2 * kMaxNeedle: load factor <= 1/2

enum PrefilterMode { kPfNone = 0, kPfGreedy = 1, kPfDp = 2 };

int block_rows(int W, bool unicode) {
  const int rb = (kStageBytes / (unicode ? 4 * W : W)) & ~31;
  return rb < 32 ? 32 : (rb > kMaxThreads ? kMaxThreads : rb);
}

// staged words per row: W bytes pack 4 to a word; codepoints are a word
int row_words(int W, bool unicode) { return unicode ? W : W / 4; }

__device__ __forceinline__ int hash_slot(int c) {
  return (int)(((unsigned)c * 2654435761u) >> 24);
}

template <int NMAX, bool UNICODE>
__global__ void __launch_bounds__(kMaxThreads) match_units_kernel(
    const void* __restrict__ cp, const int* __restrict__ n_units,
    const int* __restrict__ scalars, const int* __restrict__ rows,
    const int* __restrict__ idx, int B, int W, int n, int T, int pf_mode,
    Scoring sc, int idx_bits, long long* __restrict__ keys_out,
    int* __restrict__ cols_out) {
  extern __shared__ uint32_t s_hay[];                // rows x (words + 1)
  // bytes: byte value -> masks; codepoints: hash slot -> masks of s_key
  __shared__ unsigned long long s_occ[256];          // units it matches
  __shared__ unsigned long long s_eq[256];           // units it equals (orig)
  __shared__ int s_key[kHashSlots];
  __shared__ int s_row[kMaxThreads];

  const int rb = blockDim.x;
  const int tid = threadIdx.x;
  const int q = blockIdx.y;
  const int i0 = blockIdx.x * rb;
  const int i = i0 + tid;
  const int* scal = scalars + (long long)q * kScalars;
  const int count = max(0, min(scal[0], B));
  const long long out_i = (long long)q * B + i;
  const int words = UNICODE ? W : W / 4;
  const int stride = words + 1;

  if (i0 < count) {
    if (UNICODE) {
      for (int c = tid; c < kHashSlots; c += rb) s_key[c] = -1;
      __syncthreads();
      // one thread per needle value (orig then flip): its masks, then its
      // slot; a value already present was inserted with the same masks
      for (int t = tid; t < 2 * n; t += rb) {
        const int v = t < n ? scal[2 + t] : scal[2 + kMaxNeedle + t - n];
        unsigned long long occ = 0, eq = 0;
        for (int k = 0; k < n; ++k) {
          const int o = scal[2 + k];
          if (v == o) eq |= 1ull << k;
          if (v == o || v == scal[2 + kMaxNeedle + k]) occ |= 1ull << k;
        }
        int h = hash_slot(v);
        while (true) {
          const int prev = atomicCAS(&s_key[h], -1, v);
          if (prev == -1) {
            s_occ[h] = occ;
            s_eq[h] = eq;
            break;
          }
          if (prev == v) break;
          h = (h + 1) & (kHashSlots - 1);
        }
      }
    } else {
      for (int c = tid; c < 256; c += rb) {
        unsigned long long occ = 0, eq = 0;
        for (int k = 0; k < n; ++k) {
          const int o = scal[2 + k];
          if (c == o) eq |= 1ull << k;
          if (c == o || c == scal[2 + kMaxNeedle + k]) occ |= 1ull << k;
        }
        s_occ[c] = occ;
        s_eq[c] = eq;
      }
    }
    s_row[tid] = i < count ? (rows != nullptr ? rows[out_i] : i) : -1;
    __syncthreads();
    // stage the block's live rows: consecutive threads, consecutive words
    for (int c = tid; c < rb * words; c += rb) {
      const int r = c / words;
      const int w = c - r * words;
      const int row = s_row[r];
      if (row >= 0)
        s_hay[r * stride + w] =
            static_cast<const uint32_t*>(cp)[(long long)row * words + w];
    }
    __syncthreads();
  }
  if (i >= B) return;
  if (i >= count) {
    if (keys_out != nullptr) {
      keys_out[out_i] = kKeySentinel;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) cols_out[out_i * 8 + c] = 0;
    }
    return;
  }

  const int row = s_row[tid];
  const int nu = n_units[row];
  const int len = min(nu, W);
  const uint32_t* hay = s_hay + tid * stride;
  auto unit = [&](int j) -> int {
    return UNICODE ? (int)hay[j] : (int)((hay[j >> 2] >> ((j & 3) * 8)) & 0xFFu);
  };
  // where the needle masks of value c live: its byte, or its hash slot
  // (-1 when c is no needle value)
  auto slot_of = [&](int c) -> int {
    if (!UNICODE) return c;
    int h = hash_slot(c);
    while (s_key[h] != c && s_key[h] != -1) h = (h + 1) & (kHashSlots - 1);
    return s_key[h] == c ? h : -1;
  };
  // the units value c matches (orig or flip), and those it equals (orig)
  auto occ_at = [&](int s) -> unsigned long long { return s >= 0 ? s_occ[s] : 0ull; };
  auto eq_at = [&](int s) -> unsigned long long { return s >= 0 ? s_eq[s] : 0ull; };
  auto blen_of = [&](int c) -> int { return UNICODE ? ctx_blen(codepoint_ctx(c)) : 1; };

  // ---- pass 1: positional prefilter -> matched, byte window [start, end)
  // and the row's byte count nb
  bool matched = true;
  int wstart_raw = 0, wend = 0, nb = len;
  if (pf_mode == kPfGreedy) {
    // greedy leftmost embedding; start = first hit of needle[0], end =
    // last occurrence of the final unit at or after completion
    int np = 0, sbyte = 0, ebyte = 0, boff = 0;
    bool ffound = false, efound = false;
    for (int j = 0; j < len; ++j) {
      const int c = unit(j);
      const int bl = blen_of(c);
      const unsigned long long m = occ_at(slot_of(c));
      if (!ffound && (m & 1ull)) { ffound = true; sbyte = boff; }
      if (np < n && ((m >> np) & 1ull)) ++np;
      if (np >= n && ((m >> (n - 1)) & 1ull)) { efound = true; ebyte = boff + bl; }
      boff += bl;
    }
    nb = boff;
    matched = np >= n;
    wstart_raw = (matched && ffound) ? sbyte : 0;
    wend = (matched && efound) ? ebyte : nb;
  } else if (pf_mode == kPfDp) {
    // minimal-position DP: gs[t] = longest needle prefix embeddable with
    // <= t deletions; start = first occurrence among needle[0..=T], end =
    // last occurrence among the last T+1 units (n > T here)
    const unsigned long long all_n = n == 64 ? ~0ull : (1ull << n) - 1;
    const unsigned long long low = (1ull << (T + 1)) - 1;
    const unsigned long long tail = all_n & ~((1ull << (n - 1 - T)) - 1);
    int gs[kMaxTypos + 1];
#pragma unroll
    for (int t = 0; t <= kMaxTypos; ++t) gs[t] = t;
    int sbyte = 0, ebyte = 0, boff = 0;
    bool ffound = false, efound = false;
    for (int j = 0; j < len; ++j) {
      const int c = unit(j);
      const int bl = blen_of(c);
      const unsigned long long m = occ_at(slot_of(c));
      bool hit[kMaxTypos + 1];
#pragma unroll
      for (int t = 0; t <= kMaxTypos; ++t)
        hit[t] = t <= T && gs[t] < n && ((m >> gs[t]) & 1ull);
#pragma unroll
      for (int t = 0; t <= kMaxTypos; ++t) gs[t] += hit[t] ? 1 : 0;
#pragma unroll
      for (int t = 1; t <= kMaxTypos; ++t)
        if (t <= T) gs[t] = max(gs[t], gs[t - 1] + 1);
      if (!ffound && (m & low)) { ffound = true; sbyte = boff; }
      if (m & tail) { efound = true; ebyte = boff + bl; }
      boff += bl;
    }
    nb = boff;
    int g_last = 0;
#pragma unroll
    for (int t = 0; t <= kMaxTypos; ++t)
      if (t == T) g_last = gs[t];
    matched = g_last >= n;
    wstart_raw = (matched && ffound) ? sbyte : 0;
    wend = (matched && efound) ? ebyte : nb;
  } else {
    if (UNICODE) {
      nb = 0;
      for (int j = 0; j < len; ++j) nb += blen_of(unit(j));
    }
    wend = nb;
  }

  int score = 0, exact = 0, end_col = 0, greedy = 0;
  if (matched || keys_out == nullptr) {
    // ---- pass 2: affine-gap SW over the start-1-trimmed window
    const int wstart = max(wstart_raw - 1, 0);
    const bool include_exact = wstart == 0 && wend == nb;
    const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
    int h[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) h[k] = 0;
    unsigned long long mm = 0;  // previous column's per-unit match bits
    int prev = 0, best = 0, end_b = 0;
    bool first = true;
    // a byte row's window starts at column wstart; a codepoint row walks
    // from column 0 to the first unit at or past byte wstart
    int boff = UNICODE ? 0 : wstart;
    for (int j = UNICODE ? 0 : wstart; j < len; ++j) {
      const int c = unit(j);
      const int f = UNICODE ? codepoint_ctx(c) : byte_ctx(c);
      const int bl = UNICODE ? ctx_blen(f) : 1;
      if (boff + bl > wend) break;
      if (UNICODE && boff < wstart) {
        prev = f;
        boff += bl;
        continue;
      }
      const int sl = slot_of(c);
      const unsigned long long m = occ_at(sl);
      const unsigned long long me = eq_at(sl);
      int bonus = 0;
      if (first) {
        if (wstart == 0) bonus = sc.prefix;
        first = false;
      } else {
        bonus = context_bonus(f, prev, sc);
      }
      int diag_in = 0, up_src = 0, cur = 0;
      bool mm_prev = false;
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        if (k >= n) break;
        const bool occ = (m >> k) & 1ull;
        const int hit = sc.match + bonus + (((me >> k) & 1ull) ? sc.case_b : 0);
        const int left = h[k] - sc.gap_ext - (((mm >> k) & 1ull) ? gop_extra : 0);
        if (k == 0) {
          cur = max(occ ? hit : 0, left);
        } else {
          const int diag = occ ? diag_in + hit : max(diag_in - sc.mismatch, 0);
          const int up = max(up_src - sc.gap_ext - (mm_prev ? gop_extra : 0), 0);
          cur = max(max(diag, up), left);
        }
        diag_in = h[k];
        up_src = cur;
        mm_prev = occ;
        h[k] = cur;
      }
      if (cur > best) { best = cur; end_b = boff; }  // cur = unit n-1's cell
      mm = m;
      prev = f;
      boff += bl;
    }
    // exact: the row equals the needle's original units (a unit past the
    // width compares as 0, as the reference's lane gather does)
    bool eq = nu == n;
    for (int k = 0; k < n && eq; ++k) eq = (k < W ? unit(k) : 0) == scal[2 + k];
    score = best;
    end_col = score > 0 ? end_b : wstart;
    exact = (include_exact && eq) ? 1 : 0;
    if (exact) score = min(score + sc.exact, 0xFFFF);
    greedy = (matched && (wend - wstart) > kMaxHaystackLen) ? 1 : 0;
  }

  if (keys_out != nullptr) {
    keys_out[out_i] =
        frizbee::pack_key(matched, score, exact, end_col, greedy, idx[row], idx_bits);
  } else {
    int* o = cols_out + out_i * 8;
    o[0] = matched ? 1 : 0;
    o[1] = score;
    o[2] = exact;
    o[3] = end_col;
    o[4] = greedy;
    o[5] = o[6] = o[7] = 0;
  }
}

template <int NMAX, bool UNICODE>
int launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
           const void* cp, const int* nu, const int* scalars, const int* rows,
           const int* idx, int B, int W, int n, int T, int pf_mode, Scoring sc,
           int idx_bits, long long* keys_out, int* cols_out) {
  auto kernel = match_units_kernel<NMAX, UNICODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(cp, nu, scalars, rows, idx, B, W, n,
                                          T, pf_mode, sc, idx_bits, keys_out,
                                          cols_out);
  return 0;
}

template <bool UNICODE>
int launch_n(dim3 grid, int threads, size_t smem, cudaStream_t stream,
             const void* cp, const int* nu, const int* scalars, const int* rows,
             const int* idx, int B, int W, int n, int T, int pf_mode, Scoring sc,
             int idx_bits, long long* keys_out, int* cols_out) {
  if (n <= 16)
    return launch<16, UNICODE>(grid, threads, smem, stream, cp, nu, scalars, rows,
                               idx, B, W, n, T, pf_mode, sc, idx_bits, keys_out,
                               cols_out);
  if (n <= 32)
    return launch<32, UNICODE>(grid, threads, smem, stream, cp, nu, scalars, rows,
                               idx, B, W, n, T, pf_mode, sc, idx_bits, keys_out,
                               cols_out);
  return launch<64, UNICODE>(grid, threads, smem, stream, cp, nu, scalars, rows,
                             idx, B, W, n, T, pf_mode, sc, idx_bits, keys_out,
                             cols_out);
}

}  // namespace

// C entry point (bound with ctypes). cp (B, W) rows: int8 bytes (4-byte
// aligned, W a multiple of 4) or, when unicode != 0, int32 codepoints; W
// <= 1024; n_units (B,) int32; scalars (Q, 130) int32 with [q, 0] = query
// q's live count; rows (Q, B) int32 or null (identity); idx (B,) int32
// corpus indices (key-emit mode) or null; scoring (9,) host int32. Writes
// keys_out (Q, B) int64 when non-null, else cols_out (Q, B, 8) int32 =
// matched, score, exact, end_col, greedy, 0, 0, 0. Returns the error of
// the shared-memory opt-in, else cudaGetLastError() after the launch.
extern "C" int match_units_launch(
    const void* cp, const void* n_units, const void* scalars, const void* rows,
    const void* idx, int Q, int B, int W, int n, int T, int pf_mode,
    int unicode, const void* scoring, int idx_bits, void* keys_out,
    void* cols_out, void* stream) {
  if (Q == 0 || B == 0) return 0;
  if (n < 1 || n > kMaxNeedle || T < 0 || T > kMaxTypos || W < 4 || W % 4 ||
      W > kMaxHaystackLen || (keys_out != nullptr && idx == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool u = unicode != 0;
  const Scoring sc = frizbee::scoring_from(scoring);
  const int rb = block_rows(W, u);
  const dim3 grid((B + rb - 1) / rb, Q);
  const size_t smem = (size_t)rb * (row_words(W, u) + 1) * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(n_units);
  const int* c = static_cast<const int*>(scalars);
  const int* d = static_cast<const int*>(rows);
  const int* e = static_cast<const int*>(idx);
  long long* ko = static_cast<long long*>(keys_out);
  int* co = static_cast<int*>(cols_out);
  const int rc = u ? launch_n<true>(grid, rb, smem, st, cp, b, c, d, e, B, W, n, T,
                                    pf_mode, sc, idx_bits, ko, co)
                   : launch_n<false>(grid, rb, smem, st, cp, b, c, d, e, B, W, n,
                                     T, pf_mode, sc, idx_bits, ko, co);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
