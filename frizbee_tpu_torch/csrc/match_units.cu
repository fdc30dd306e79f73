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
// The needle arrives as unit masks per value (the units a value matches,
// orig or flip; the units whose original case it equals), 32-bit words
// for needles of up to 32 units (one shared-memory bank a lookup, one
// 32-bit shift a test), else 64-bit. So the T=0 greedy embedding and the
// minimal-position DP cost O(T) per column, not O(n*T), and the SW DP's
// per-unit match bits are bit tests of one register. Bytes index two
// 256-entry tables. Codepoints look up a 256-slot open-addressing hash
// table in shared memory holding the needle's <= 128 distinct orig/flip
// values: each value's masks are built by the thread that inserts it (one
// thread per needle value, atomicCAS on the key), so a lookup equals
// ``c == orig[k] || c == flip[k]`` bit for bit, and a value outside the
// needle ends its probe at an empty slot. h[k] lives in registers; the
// kernel is templated on a ceiling NMAX in {16, 32, 64} with the needle
// length n at run time, and on a ceiling TMAX in {1, 2, 4, 8} of the typo
// budget T of the minimal-position DP (TMAX = 0: the greedy embedding or
// no prefilter), so a budget of 4 runs 5 DP states, not 9.
//
// A codepoint row's window and end_col are UTF-8 byte offsets: each column
// derives its lead and last byte and length from the codepoint (as
// _unit_context does) and the walk carries the byte offset; the DP walks
// from column 0 to the first unit at or past the window's start byte.
//
// As in _match_tile, rows the prefilter rejects still run the DP over the
// full row in columns mode (their score, exact and end_col are part of the
// (B, 8) result), each thread on its own row. Key-emit mode writes their
// sentinel without it and, behind the typo-budget prefilter, compacts
// the block's matched rows: a warp ballot and a block prefix put each
// matched row's (staged slot, window, byte count) into a shared queue in
// row order, and threads 0..m-1 run the DP on the queue, so every lane of
// a DP warp has a row and the other warps end after pass 1. The DP cell
// takes Hopper's DPX add-max instructions (__viaddmax_s32,
// __viaddmax_s32_relu): two on the cell's serial path from the unit
// before.
//
// Bound on this card: integer ALU work, ~14 int32 operations per (column,
// needle unit) cell of each matched row's trimmed window plus ~6 + 3(T+1)
// per column of every live row's prefilter, against W bytes (4W for
// codepoints) per live row.
//
// The int16-lane instantiation (PAIRS; the reference's int16_lanes=True,
// byte rows where ops/kernels.score_fits_int16 holds) runs pass 1 per row
// as above and pass 2 two rows a thread, in the s16x2 halves of 32-bit
// registers (lanes16.cuh): every row that runs pass 2 goes to the queue
// (the block's behind the typo-budget prefilter, each warp's own behind
// the greedy embedding), and its thread t takes queue entries 2t (low
// half) and 2t + 1 (high half), neighbours in the survivor order, so of
// about one length. The pair walks the union of its two trimmed windows;
// each half takes the needle masks of its byte only inside its own window
// (outside it a half's cells stay 0 before the window and never reach its
// best after it), its own first-column and context bonus, and its own
// best and end column (best2:
// a DPX max and the halves it changed; the predicates of __vibmax_s16x2
// left every end column at 0 here, measured on an H100: PERF.md). Per
// (column, needle unit) the pair costs three prmt half masks (unit match,
// case match, the previous column's match), three selects and three DPX
// add-max (__viaddmax_s16x2 and its relu form), where two int32 rows cost
// two of each bit test and select and four DPX. Scores, exact and the key
// are unpacked to 32 bits at the end. An odd row out runs with an idle
// high half.

#include <type_traits>

#include "lanes16.cuh"

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

// resident blocks per SM asked of ptxas, by needle ceiling (h[NMAX] in
// registers): 128-thread blocks at <= 128 registers (NMAX 16, 32) and
// <= 168 (NMAX 64)
template <int NMAX>
constexpr int kMinBlocks = NMAX <= 32 ? 4 : 3;

__device__ __forceinline__ int hash_slot(int c) {
  return (int)(((unsigned)c * 2654435761u) >> 24);
}

template <int NMAX, int TMAX, bool UNICODE, bool PAIRS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<NMAX>)
    match_units_kernel(const void* __restrict__ cp, const int* __restrict__ n_units,
                       const int* __restrict__ scalars, const int* __restrict__ rows,
                       const int* __restrict__ idx, int B, int W, int n, int T,
                       int pf_mode, Scoring sc, int idx_bits,
                       long long* __restrict__ keys_out, int* __restrict__ cols_out) {
  using Mask = std::conditional_t<(NMAX <= 32), uint32_t, unsigned long long>;
  constexpr int kMaskBits = 8 * sizeof(Mask);
  extern __shared__ uint32_t s_hay[];                // rows x (words + 1)
  // bytes: byte value -> masks; codepoints: hash slot -> masks of s_key
  __shared__ Mask s_occ[256];                        // units it matches
  __shared__ Mask s_eq[256];                         // units it equals (orig)
  __shared__ int s_key[UNICODE ? kHashSlots : 1];
  __shared__ uint8_t s_ctx[PAIRS ? 256 : 1];         // byte -> byte_ctx
  __shared__ int s_row[kMaxThreads];
  __shared__ int4 s_queue[kMaxThreads];              // slot, wstart, wend, nb
  __shared__ int s_warp_n[kMaxThreads / 32];

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

  if (i0 >= count) {  // the whole block lies past the live count
    if (i >= B) return;
    if (keys_out != nullptr) {
      keys_out[out_i] = kKeySentinel;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) cols_out[out_i * 8 + c] = 0;
    }
    return;
  }

  if constexpr (UNICODE) {
    for (int c = tid; c < kHashSlots; c += rb) s_key[c] = -1;
    __syncthreads();
    // one thread per needle value (orig then flip): its masks, then its
    // slot; a value already present was inserted with the same masks
    for (int t = tid; t < 2 * n; t += rb) {
      const int v = t < n ? scal[2 + t] : scal[2 + kMaxNeedle + t - n];
      Mask occ = 0, eq = 0;
      for (int k = 0; k < n; ++k) {
        const int o = scal[2 + k];
        if (v == o) eq |= Mask(1) << k;
        if (v == o || v == scal[2 + kMaxNeedle + k]) occ |= Mask(1) << k;
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
      Mask occ = 0, eq = 0;
      for (int k = 0; k < n; ++k) {
        const int o = scal[2 + k];
        if (c == o) eq |= Mask(1) << k;
        if (c == o || c == scal[2 + kMaxNeedle + k]) occ |= Mask(1) << k;
      }
      s_occ[c] = occ;
      s_eq[c] = eq;
      if constexpr (PAIRS) s_ctx[c] = (uint8_t)byte_ctx(c);
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

  // where the needle masks of value c live: its byte, or its hash slot
  // (-1 when c is no needle value)
  auto slot_of = [&](int c) -> int {
    if constexpr (!UNICODE) {
      return c;
    } else {
      int h = hash_slot(c);
      while (s_key[h] != c && s_key[h] != -1) h = (h + 1) & (kHashSlots - 1);
      return s_key[h] == c ? h : -1;
    }
  };
  // the units value c matches (orig or flip), and those it equals (orig)
  auto occ_at = [&](int s) -> Mask { return s >= 0 ? s_occ[s] : Mask(0); };
  auto eq_at = [&](int s) -> Mask { return s >= 0 ? s_eq[s] : Mask(0); };
  auto unit_of = [&](const uint32_t* hay, int j) -> int {
    return UNICODE ? (int)hay[j] : (int)((hay[j >> 2] >> ((j & 3) * 8)) & 0xFFu);
  };
  auto blen_of = [&](int c) -> int { return UNICODE ? ctx_blen(codepoint_ctx(c)) : 1; };

  // ---- pass 1: positional prefilter -> matched, byte window [start, end)
  // and the row's byte count nb
  const bool live = i < count;
  bool matched = true;
  int wstart_raw = 0, wend = 0, nb = 0;
  if (live) {
    const uint32_t* hay = s_hay + tid * stride;
    const int len = min(n_units[s_row[tid]], W);
    int boff = 0;
    if (TMAX == 0 && pf_mode == kPfGreedy) {
      // greedy leftmost embedding; start = first hit of needle[0], end =
      // last occurrence of the final unit at or after completion
      int np = 0, sbyte = 0, ebyte = 0;
      bool ffound = false, efound = false;
      for (int j = 0; j < len; ++j) {
        const int c = unit_of(hay, j);
        const int bl = blen_of(c);
        const Mask m = occ_at(slot_of(c));
        if (!ffound && (m & Mask(1))) { ffound = true; sbyte = boff; }
        if (np < n && ((m >> np) & Mask(1))) ++np;
        if (np >= n && ((m >> (n - 1)) & Mask(1))) { efound = true; ebyte = boff + bl; }
        boff += bl;
      }
      nb = boff;
      matched = np >= n;
      wstart_raw = (matched && ffound) ? sbyte : 0;
      wend = (matched && efound) ? ebyte : nb;
    } else if (TMAX > 0) {
      // minimal-position DP (pf_mode == kPfDp, 0 < T <= TMAX < n): gs[t] =
      // longest needle prefix embeddable with <= t deletions; start = first
      // occurrence among needle[0..=T], end = last occurrence among the
      // last T+1 units. States past T take no hits, only the closure, so
      // gs[TMAX] = gs[T] + TMAX - T.
      const Mask all_n = n == kMaskBits ? ~Mask(0) : (Mask(1) << n) - 1;
      const Mask low = (Mask(1) << (T + 1)) - 1;
      const Mask tail = all_n & ~((Mask(1) << (n - 1 - T)) - 1);
      int gs[TMAX + 1];
#pragma unroll
      for (int t = 0; t <= TMAX; ++t) gs[t] = t;
      int sbyte = 0, ebyte = 0;
      bool ffound = false, efound = false;
      for (int j = 0; j < len; ++j) {
        const int c = unit_of(hay, j);
        const int bl = blen_of(c);
        const Mask m = occ_at(slot_of(c));
        bool hit[TMAX + 1];
#pragma unroll
        for (int t = 0; t <= TMAX; ++t)
          hit[t] = t <= T && gs[t] < n && ((m >> gs[t]) & Mask(1));
#pragma unroll
        for (int t = 0; t <= TMAX; ++t) gs[t] += hit[t] ? 1 : 0;
#pragma unroll
        for (int t = 1; t <= TMAX; ++t) gs[t] = max(gs[t], gs[t - 1] + 1);
        if (!ffound && (m & low)) { ffound = true; sbyte = boff; }
        if (m & tail) { efound = true; ebyte = boff + bl; }
        boff += bl;
      }
      nb = boff;
      matched = gs[TMAX] >= n + TMAX - T;
      wstart_raw = (matched && ffound) ? sbyte : 0;
      wend = (matched && efound) ? ebyte : nb;
    } else {
      if constexpr (UNICODE) {
        for (int j = 0; j < len; ++j) boff += blen_of(unit_of(hay, j));
      } else {
        boff = len;
      }
      nb = boff;
      wend = nb;
    }
  } else if (i < B) {
    if (keys_out != nullptr) {
      keys_out[out_i] = kKeySentinel;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) cols_out[out_i * 8 + c] = 0;
    }
  }

  if constexpr (PAIRS) {
    // ---- pass 2, two rows a thread: every row that runs pass 2 (every
    // live row in columns mode, the matched ones in key-emit mode) goes to
    // the queue in row order, its matched flag in bit 16 of the slot
    // Behind the typo-budget prefilter the queue is the block's, so its
    // pairs fill whole warps; behind the greedy embedding each warp queues
    // its own rows and pairs them, with no block barrier (which cost more
    // than it saved there in the int32 kernel: PERF.md).
    if (keys_out != nullptr && live && !matched) keys_out[out_i] = kKeySentinel;
    const bool run_row = live && (matched || keys_out == nullptr);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, run_row);
    const int warp = tid >> 5, lane = tid & 31;
    int base = 0, m = 0, qt = tid;  // queue offset, length, this thread's pair
    if constexpr (TMAX > 0) {
      if (lane == 0) s_warp_n[warp] = __popc(ballot);
      __syncthreads();
      for (int w = 0; w < (rb >> 5); ++w) {
        const int c = s_warp_n[w];
        base += w < warp ? c : 0;
        m += c;
      }
    } else {
      base = tid & ~31;
      m = __popc(ballot);
      qt = lane;
    }
    if (run_row)
      s_queue[base + __popc(ballot & ((1u << lane) - 1u))] =
          make_int4(tid | (matched ? 0x10000 : 0), wstart_raw, wend, nb);
    if constexpr (TMAX > 0) {
      __syncthreads();
      base = 0;
    } else {
      __syncwarp();
    }
    if (2 * qt >= m) return;
    const bool two = 2 * qt + 1 < m;
    const int4 e0 = s_queue[base + 2 * qt];
    const int4 e1 = two ? s_queue[base + 2 * qt + 1] : e0;
    const uint32_t* hay0 = s_hay + (e0.x & 0xFFFF) * stride;
    const uint32_t* hay1 = s_hay + (e1.x & 0xFFFF) * stride;
    // the trimmed windows [ws, we) in columns (a byte row's bytes); the
    // idle half of an odd row out has none
    const int ws0 = max(e0.y - 1, 0), we0 = e0.z;
    const int ws1 = max(e1.y - 1, 0), we1 = two ? e1.z : 0;
    int jlo = W, jhi = 0;
    if (ws0 < we0) { jlo = ws0; jhi = we0; }
    if (ws1 < we1) { jlo = min(jlo, ws1); jhi = max(jhi, we1); }
    const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
    const int mis = min(sc.mismatch, frizbee::kInt16ScoreLimit);
    const uint32_t nge = frizbee::pack2(-sc.gap_ext, -sc.gap_ext);
    const uint32_t ngeo = frizbee::pack2(-(sc.gap_ext + gop_extra),
                                         -(sc.gap_ext + gop_extra));
    const uint32_t neg_mm = frizbee::pack2(-mis, -mis);
    using Bits = frizbee::PairBits<Mask, (NMAX <= 16)>;
    // needles of up to 16 units keep each unit's left-gap cost for the
    // next column in registers; longer ones rebuild it from the previous
    // column's bits (po), as registers would spill
    constexpr bool kGapRegs = NMAX <= 16;
    uint32_t h[NMAX], gl[kGapRegs ? NMAX : 1];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) h[k] = 0;
    if constexpr (kGapRegs) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k) gl[k] = nge;
    }
    Bits po;  // the previous column's unit matches
    uint32_t best = 0;
    int end0 = 0, end1 = 0;
    int p0 = 0, p1 = 0;  // the previous column's byte facts of each half
    for (int j = jlo; j < jhi; ++j) {
      const bool a0 = j >= ws0 && j < we0, a1 = j >= ws1 && j < we1;
      const int c0 = unit_of(hay0, j), c1 = unit_of(hay1, j);
      const Bits pm(a0 ? s_occ[c0] : Mask(0), a1 ? s_occ[c1] : Mask(0));
      const Bits pe(a0 ? s_eq[c0] : Mask(0), a1 ? s_eq[c1] : Mask(0));
      // each half's bonus: the prefix bonus (or none) on its window's
      // first column, else the context bonus after the byte before
      const int f0 = s_ctx[c0], f1 = s_ctx[c1];
      int b0 = 0, b1 = 0;
      if (a0) b0 = j == ws0 ? (ws0 == 0 ? sc.prefix : 0) : context_bonus(f0, p0, sc);
      if (a1) b1 = j == ws1 ? (ws1 == 0 ? sc.prefix : 0) : context_bonus(f1, p1, sc);
      p0 = f0;
      p1 = f1;
      const uint32_t base_hit = frizbee::pack2(sc.match + b0, sc.match + b1);
      const uint32_t case_hit =
          frizbee::pack2(sc.match + sc.case_b + b0, sc.match + sc.case_b + b1);
      // unit 0: no diagonal or up source. gu: the up move's gap after unit
      // k-1 at this column, which is also unit k-1's left gap at the next
      uint32_t mo = pm.mask(0);
      uint32_t gu = frizbee::sel2(mo, ngeo, nge);
      uint32_t gl0;
      if constexpr (kGapRegs) {
        gl0 = gl[0];
        gl[0] = gu;
      } else {
        gl0 = frizbee::sel2(po.mask(0), ngeo, nge);
      }
      uint32_t cur = __viaddmax_s16x2(
          h[0], gl0, frizbee::hit2(mo, pe.mask(0), case_hit, base_hit, 0u));
      uint32_t diag_in = h[0];
      h[0] = cur;
#pragma unroll
      for (int k = 1; k < NMAX; ++k) {
        if (k >= n) break;
        mo = pm.mask(k);
        const uint32_t d = frizbee::hit2(mo, pe.mask(k), case_hit, base_hit, neg_mm);
        const uint32_t gk = frizbee::sel2(mo, ngeo, nge);
        uint32_t glk;
        if constexpr (kGapRegs) {
          glk = gl[k];
          gl[k] = gk;
        } else {
          glk = frizbee::sel2(po.mask(k), ngeo, nge);
        }
        cur = frizbee::cell2(diag_in, d, cur, gu, h[k], glk);
        diag_in = h[k];
        h[k] = cur;
        gu = gk;
      }
      // unit n-1's cell, inside each half's window, against its best
      int raised;
      best = frizbee::best2(best, cur & ((a0 ? 0xFFFFu : 0u) | (a1 ? 0xFFFF0000u : 0u)),
                            &raised);
      if (raised & 1) end0 = j;
      if (raised & 2) end1 = j;
      if constexpr (!kGapRegs) po = pm;
    }
    // each half's outputs, unpacked to 32 bits
    auto finish = [&](const int4& e, const uint32_t* hay, int ws, int score, int end) {
      const int sl = e.x & 0xFFFF;
      const bool mt = (e.x >> 16) != 0;
      const int row = s_row[sl];
      const int nu = n_units[row];
      bool eq = nu == n;
      for (int k = 0; k < n && eq; ++k) eq = (k < W ? unit_of(hay, k) : 0) == scal[2 + k];
      const int end_col = score > 0 ? end : ws;
      const int exact = (ws == 0 && e.z == e.w && eq) ? 1 : 0;
      if (exact) score = min(score + sc.exact, 0xFFFF);
      const int greedy = (mt && (e.z - ws) > kMaxHaystackLen) ? 1 : 0;
      const long long o_i = (long long)q * B + i0 + sl;
      if (keys_out != nullptr) {
        keys_out[o_i] = frizbee::pack_key(true, score, exact, end_col, greedy, idx[row],
                                          idx_bits);
      } else {
        int* o = cols_out + o_i * 8;
        o[0] = mt ? 1 : 0;
        o[1] = score;
        o[2] = exact;
        o[3] = end_col;
        o[4] = greedy;
        o[5] = o[6] = o[7] = 0;
      }
    };
    finish(e0, hay0, ws0, frizbee::lo16(best), end0);
    if (two) finish(e1, hay1, ws1, frizbee::hi16(best), end1);
    return;
  }

  // ---- who runs pass 2: in columns mode every live row, rejected or
  // not, on its own thread; in key-emit mode the matched rows, rejected
  // ones taking the sentinel. Behind a typo-budget prefilter (TMAX > 0)
  // the block's matched rows go to the queue and threads 0..m-1 run
  // them; behind the greedy embedding each thread runs its own, as the
  // queue's block barrier cost more than it saved there (measured on an
  // H100: PERF.md).
  if (keys_out != nullptr && live && !matched) keys_out[out_i] = kKeySentinel;
  int slot = tid;
  bool run = live && (matched || keys_out == nullptr);
  if (TMAX > 0 && keys_out != nullptr) {
    // compaction: matched rows to the queue
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, run);
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0) s_warp_n[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, m = 0;
    for (int w = 0; w < (rb >> 5); ++w) {
      const int c = s_warp_n[w];
      base += w < warp ? c : 0;
      m += c;
    }
    if (run)
      s_queue[base + __popc(ballot & ((1u << lane) - 1u))] =
          make_int4(tid, wstart_raw, wend, nb);
    __syncthreads();
    run = tid < m;
    if (run) {
      const int4 e = s_queue[tid];
      slot = e.x;
      wstart_raw = e.y;
      wend = e.z;
      nb = e.w;
      matched = true;
    }
  }
  if (!run) return;

  // ---- pass 2: affine-gap SW over the start-1-trimmed window of the row
  // staged in ``slot``
  const uint32_t* hay = s_hay + slot * stride;
  const int row = s_row[slot];
  const int nu = n_units[row];
  const int len = min(nu, W);
  const int wstart = max(wstart_raw - 1, 0);
  const bool include_exact = wstart == 0 && wend == nb;
  const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
  const int ge = sc.gap_ext, geo = sc.gap_ext + gop_extra;
  int h[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) h[k] = 0;
  Mask mm = 0;  // previous column's per-unit match bits
  int prev = 0, best = 0, end_b = 0;
  bool first = true;
  // a byte row's window starts at column wstart; a codepoint row walks
  // from column 0 to the first unit at or past byte wstart
  int boff = UNICODE ? 0 : wstart;
  for (int j = UNICODE ? 0 : wstart; j < len; ++j) {
    const int c = unit_of(hay, j);
    const int f = UNICODE ? codepoint_ctx(c) : byte_ctx(c);
    const int bl = UNICODE ? ctx_blen(f) : 1;
    if (boff + bl > wend) break;
    if (UNICODE && boff < wstart) {
      prev = f;
      boff += bl;
      continue;
    }
    const int sl = slot_of(c);
    const Mask m = occ_at(sl);
    const Mask me = eq_at(sl);
    int bonus = 0;
    if (first) {
      if (wstart == 0) bonus = sc.prefix;
      first = false;
    } else {
      bonus = context_bonus(f, prev, sc);
    }
    const int base_hit = sc.match + bonus;
    // unit 0: no diagonal or up source
    const bool occ0 = m & Mask(1);
    int cur = max(occ0 ? base_hit + ((me & Mask(1)) ? sc.case_b : 0) : 0,
                  h[0] - ((mm & Mask(1)) ? geo : ge));
    int diag_in = h[0];
    int g_up = occ0 ? geo : ge;  // the up move's gap cost after unit k-1
    h[0] = cur;
    // unit k: max(diag_in + (hit or -mismatch), cur[k-1] - g_up,
    // h[k] - g_left, 0); the relu stands in for both the diagonal's
    // mismatch floor and the up move's
#pragma unroll
    for (int k = 1; k < NMAX; ++k) {
      if (k >= n) break;
      const bool occ = (m >> k) & Mask(1);
      const int d = occ ? base_hit + (((me >> k) & Mask(1)) ? sc.case_b : 0)
                        : -sc.mismatch;
      const int left = h[k] - (((mm >> k) & Mask(1)) ? geo : ge);
      cur = __viaddmax_s32_relu(diag_in, d, __viaddmax_s32(cur, -g_up, left));
      diag_in = h[k];
      h[k] = cur;
      g_up = occ ? geo : ge;
    }
    if (cur > best) { best = cur; end_b = boff; }  // cur = unit n-1's cell
    mm = m;
    prev = f;
    boff += bl;
  }
  // exact: the row equals the needle's original units (a unit past the
  // width compares as 0, as the reference's lane gather does)
  bool eq = nu == n;
  for (int k = 0; k < n && eq; ++k) eq = (k < W ? unit_of(hay, k) : 0) == scal[2 + k];
  int score = best;
  const int end_col = score > 0 ? end_b : wstart;
  const int exact = (include_exact && eq) ? 1 : 0;
  if (exact) score = min(score + sc.exact, 0xFFFF);
  const int greedy = (matched && (wend - wstart) > kMaxHaystackLen) ? 1 : 0;

  const long long o_i = (long long)q * B + i0 + slot;
  if (keys_out != nullptr) {
    keys_out[o_i] = frizbee::pack_key(true, score, exact, end_col, greedy, idx[row],
                                      idx_bits);
  } else {
    int* o = cols_out + o_i * 8;
    o[0] = matched ? 1 : 0;
    o[1] = score;
    o[2] = exact;
    o[3] = end_col;
    o[4] = greedy;
    o[5] = o[6] = o[7] = 0;
  }
}

// one launch's configuration and operands
struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
  cudaStream_t stream;
  const void* cp;
  const int *nu, *scalars, *rows, *idx;
  int B, W, n, T, pf_mode;
  Scoring sc;
  int idx_bits;
  long long* keys_out;
  int* cols_out;
};

template <int NMAX, int TMAX, bool UNICODE, bool PAIRS>
int launch(const Launch& a) {
  auto kernel = match_units_kernel<NMAX, TMAX, UNICODE, PAIRS>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.grid, a.threads, a.smem, a.stream>>>(
      a.cp, a.nu, a.scalars, a.rows, a.idx, a.B, a.W, a.n, a.T, a.pf_mode, a.sc,
      a.idx_bits, a.keys_out, a.cols_out);
  return 0;
}

// the instantiation for a needle ceiling: TMAX = 0 serves no prefilter
// and the greedy embedding, else the least of 1, 2, 4, 8 >= T
template <int NMAX, bool UNICODE, bool PAIRS>
int launch_t(const Launch& a) {
  if (a.pf_mode != kPfDp) return launch<NMAX, 0, UNICODE, PAIRS>(a);
  if (a.T <= 1) return launch<NMAX, 1, UNICODE, PAIRS>(a);
  if (a.T <= 2) return launch<NMAX, 2, UNICODE, PAIRS>(a);
  if (a.T <= 4) return launch<NMAX, 4, UNICODE, PAIRS>(a);
  return launch<NMAX, 8, UNICODE, PAIRS>(a);
}

template <bool UNICODE, bool PAIRS>
int launch_n(const Launch& a) {
  if (a.n <= 16) return launch_t<16, UNICODE, PAIRS>(a);
  if (a.n <= 32) return launch_t<32, UNICODE, PAIRS>(a);
  return launch_t<64, UNICODE, PAIRS>(a);
}

}  // namespace

// C entry point (bound with ctypes). cp (B, W) rows: int8 bytes (4-byte
// aligned, W a multiple of 4) or, when unicode != 0, int32 codepoints; W
// <= 1024; n_units (B,) int32; scalars (Q, 130) int32 with [q, 0] = query
// q's live count; rows (Q, B) int32 or null (identity); idx (B,) int32
// corpus indices (key-emit mode) or null; scoring (9,) host int32;
// int16_lanes != 0 runs the int16-lane instantiation (byte rows; the
// caller has checked the scoring against score_fits_int16). Writes
// keys_out (Q, B) int64 when non-null, else cols_out (Q, B, 8) int32 =
// matched, score, exact, end_col, greedy, 0, 0, 0. Returns the error of
// the shared-memory opt-in, else cudaGetLastError() after the launch.
extern "C" int match_units_launch(
    const void* cp, const void* n_units, const void* scalars, const void* rows,
    const void* idx, int Q, int B, int W, int n, int T, int pf_mode,
    int unicode, int int16_lanes, const void* scoring, int idx_bits,
    void* keys_out, void* cols_out, void* stream) {
  if (Q == 0 || B == 0) return 0;
  if (n < 1 || n > kMaxNeedle || T < 0 || T > kMaxTypos || W < 4 || W % 4 ||
      W > kMaxHaystackLen || (keys_out != nullptr && idx == nullptr) ||
      (pf_mode == kPfDp && (T == 0 || T >= n)) ||
      (int16_lanes != 0 && unicode != 0))
    return (int)cudaErrorInvalidValue;
  const bool u = unicode != 0;
  const int rb = block_rows(W, u);
  const Launch a{dim3((B + rb - 1) / rb, Q), rb,
                 (size_t)rb * (row_words(W, u) + 1) * sizeof(uint32_t),
                 static_cast<cudaStream_t>(stream), cp,
                 static_cast<const int*>(n_units), static_cast<const int*>(scalars),
                 static_cast<const int*>(rows), static_cast<const int*>(idx), B, W,
                 n, T, pf_mode, frizbee::scoring_from(scoring), idx_bits,
                 static_cast<long long*>(keys_out), static_cast<int*>(cols_out)};
  const int rc = u             ? launch_n<true, false>(a)
                 : int16_lanes ? launch_n<false, true>(a)
                               : launch_n<false, false>(a);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
