// Column-stream fused prefilter + Smith-Waterman, fuzzy mode, for Hopper
// (sm_90a): byte corpora and codepoint (unicode) corpora.
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py
// match_units_colstream (mode="fuzzy", body _match_block, key packing
// pack_keys, dead-group sentinels), both of its unit branches and its
// int16_lanes=True instantiation (colstream_fuzzy_pairs_kernel below).
//
// Layout: rows come in 1024-row groups; row r of group g at unit column j
// is element (g*W + j)*1024 + r of cpT (int8 bytes, or int32 codepoints)
// and of the optional int8 ctx plane. One thread owns one row and walks its
// columns, so every DP dependency (greedy embedding, minimal-position DP,
// the affine gap recurrence) is a plain loop-carried register; the kernel
// is templated on n <= 16 (h[k] and the needle in registers) and on the
// unit type.
//
// The corpus tile (colstream_tile.cuh): a block owns a tile of 128, 64 or
// 32 rows of one group and stages its columns [0, longest row) in shared
// memory once, with 16-byte cp.async copies (codepoints with their ctx
// bytes), then walks each row from there for every query of its chunk
// (up to 512 / W queries) that the live count and stage-1 flag keep
// alive; the chunk's needles are staged too. A tile no query of the chunk
// keeps alive reads nothing and writes sentinels (zeros in column mode).
// While the copies fly, the block sorts its rows by length, so each warp
// walks rows of about one length. A codepoint row's class bytes (each
// unit's context bonus after its predecessor, and its byte length) are
// computed once a tile; a byte row derives its bonus from its bytes.
//
// Units and bytes. A byte row's window [start, end) and end_col are unit
// columns. A codepoint row's are UTF-8 byte offsets: each thread carries
// the byte offset of its current column and the row's byte count in
// registers. A unit's byte length comes from the staged ctx plane
// (corpus.ctx_plane), or, without a plane, from the codepoint's UTF-8 lead
// byte.
//
// Pass 1 (prefilter) at T=0 is the greedy embedding: a needle of n >= 4
// units looks its next unit up in the staged needle, and tests its first
// and last unit for the window, at the same cost for every n; shorter
// needles compare every unit, which costs less there. Pass 1 records the
// column of the window's first hit and whether the unit before it is one
// byte long, so pass 2 starts at the first unit of the start-1-trimmed
// window on byte and codepoint rows alike, never walking the columns
// before it. A row's outputs depend only on its own columns
// [0, min(nu, W)): each thread stops at its own length (the TPU kernel
// walks the group maximum; the outputs are equal). The DP cell takes
// Hopper's DPX add-max instructions: max(diag + (hit or -mismatch),
// up - gap, left - gap, 0) in two. greedy flags a matched row whose
// trimmed window exceeds 1024 bytes.
//
// Bound on this card: integer operations (chip_smoke.py counts 20 a
// column for the greedy prefilter and 10 a DP cell of each matched row's
// trimmed window), not bytes: the corpus is read once a chunk of queries.
// The 512-column cap on a block's queries keeps blocks short enough that
// no tail of long blocks ends the launch.

#include "colstream_tile.cuh"
#include "lanes16.cuh"

namespace {

using frizbee::kColstreamNeedle;
using frizbee::kGroupRows;
using frizbee::kMaxHaystackLen;
using frizbee::kMaxBlockQueries;
using frizbee::Scoring;
using frizbee::TileBlock;
using frizbee::TileRow;

enum PrefilterMode { kPfNone = 0, kPfGreedy = 1, kPfDp = 2 };
// needles of at least this many units look their next unit up in the
// greedy embedding; shorter ones compare every unit, which costs less
constexpr int kLookupFrom = 4;
// resident 128-thread blocks per SM asked of ptxas: n <= 8 fits 64
// registers
template <int N>
constexpr int kMinBlocks = N <= 8 ? 8 : 4;

struct Args {
  const void* cpT;
  const int8_t* ctxT;
  const int *nuT, *scalars, *flags, *idxT;
  int n_groups, W, Q, qper, chunks, T, pf_mode;
  Scoring sc;
  int idx_bits;
  long long* keys_out;
  int* cols_out;
};

// The outputs of row slot ``at`` for query q: its key, or its five
// columns.
__device__ __forceinline__ void emit_row(const Args& a, long long total, long long at,
                                         int q, int matched, int score, int exact,
                                         int end_col, int greedy, int idx) {
  const long long o = (long long)q * total + at;
  if (a.keys_out != nullptr) {
    a.keys_out[o] =
        frizbee::pack_key(matched, score, exact, end_col, greedy, idx, a.idx_bits);
  } else {
    const long long plane = (long long)a.Q * total;
    a.cols_out[o] = matched;
    a.cols_out[o + plane] = score;
    a.cols_out[o + 2 * plane] = exact;
    a.cols_out[o + 3 * plane] = end_col;
    a.cols_out[o + 4 * plane] = greedy;
  }
}

// Pass 1's verdict on one row for one needle: matched, the byte window
// [wstart_raw, wend), the row's byte count nb, and the column of the
// window's first hit (jf) with whether the unit before it is one byte
// long, so pass 2 can start at the trimmed window.
struct Window {
  bool matched;
  int wstart_raw, wend, nb, jf;
  bool one_before;
};

// Pass 1 of one row (``len`` units of ``row``) for one needle.
template <int N, bool UNICODE>
__device__ __forceinline__ Window prefilter(const TileRow<UNICODE>& row, int len,
                                            const int (&orig)[N], const int (&flip)[N],
                                            const int* nd, int pf_mode, int T) {
  bool pf_matched = true;
  int wstart_raw = 0, wend = 0, nb = len, jf = 0;
  bool one_before = false;
  if (pf_mode == kPfGreedy) {
    // greedy leftmost embedding: the next needle unit np is looked up
    // in the staged needle (or, for n < kLookupFrom, every unit is
    // compared); start = first hit of needle[0], end = last
    // occurrence of the final unit at or after completion
    int np = 0, sbyte = 0, ebyte = 0, boff = 0, prev_bl = 0;
    bool ffound = false, efound = false;
    for (int j = 0; j < len; ++j) {
      const int c = row.unit(j);
      const int bl = row.blen(j);
      bool hit0 = false, hitl = false;
      if (N < kLookupFrom) {
        bool occ_np = false;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const bool o = (c == orig[k]) | (c == flip[k]);
          occ_np |= (np == k) & o;
          if (k == 0) hit0 = o;
          if (k == N - 1) hitl = o;
        }
        np += occ_np ? 1 : 0;
      } else {
        hit0 = (c == orig[0]) | (c == flip[0]);
        hitl = (c == orig[N - 1]) | (c == flip[N - 1]);
        if (np < N)
          np += ((c == nd[np]) | (c == nd[kColstreamNeedle + np])) ? 1 : 0;
      }
      if (!ffound && hit0) {
        ffound = true;
        sbyte = boff;
        jf = j;
        one_before = prev_bl == 1;
      }
      if (hitl && np >= N) { efound = true; ebyte = boff + bl; }
      prev_bl = bl;
      boff += bl;
    }
    nb = boff;
    pf_matched = np >= N;
    wstart_raw = (pf_matched && ffound) ? sbyte : 0;
    wend = (pf_matched && efound) ? ebyte : nb;
  } else if (pf_mode == kPfDp) {
    // minimal-position DP: gs[t] = longest needle prefix embeddable
    // with <= t deletions; start = first occurrence among
    // needle[0..=T], end = last occurrence among the last T+1 units
    int gs[4] = {0, 1, 2, 3};
    int sbyte = 0, ebyte = 0, boff = 0, prev_bl = 0;
    bool ffound = false, efound = false;
    for (int j = 0; j < len; ++j) {
      const int c = row.unit(j);
      const int bl = row.blen(j);
      bool hits[4] = {false, false, false, false};
      bool hit_low = false, hit_tail = false;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const bool o = (c == orig[k]) | (c == flip[k]);
#pragma unroll
        for (int t = 0; t < 4; ++t) hits[t] |= (t <= T) & (gs[t] == k) & o;
        hit_low |= (k <= T) & o;
        hit_tail |= (k >= N - 1 - T) & o;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) gs[t] += hits[t] ? 1 : 0;
#pragma unroll
      for (int t = 1; t < 4; ++t)
        if (t <= T) gs[t] = max(gs[t], gs[t - 1] + 1);
      if (!ffound && hit_low) {
        ffound = true;
        sbyte = boff;
        jf = j;
        one_before = prev_bl == 1;
      }
      if (hit_tail) { efound = true; ebyte = boff + bl; }
      prev_bl = bl;
      boff += bl;
    }
    nb = boff;
    const int g_last = T == 1 ? gs[1] : (T == 2 ? gs[2] : gs[3]);
    pf_matched = g_last >= N;
    wstart_raw = (pf_matched && ffound) ? sbyte : 0;
    wend = (pf_matched && efound) ? ebyte : nb;
  } else {
    if (UNICODE) {
      nb = 0;
      for (int j = 0; j < len; ++j) nb += row.blen(j);
    }
    wend = nb;
  }
  return Window{pf_matched, wstart_raw, wend, nb, jf, one_before};
}

template <int N, bool UNICODE>
__global__ void __launch_bounds__(frizbee::kTileMaxRows, kMinBlocks<N>)
    colstream_fuzzy_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ int s_cols;
  __shared__ unsigned s_alive;
  __shared__ int s_key[frizbee::kTileMaxRows];
  __shared__ int s_needle[kMaxBlockQueries][2 * kColstreamNeedle];
  const TileBlock tb(a.chunks, a.qper, a.Q);
  const long long total = (long long)a.n_groups * kGroupRows;
  const Scoring& sc = a.sc;

  // the outputs of row slot ``at`` for query q
  auto emit = [&](long long at, int q, int matched, int score, int exact,
                  int end_col, int greedy, int idx) {
    emit_row(a, total, at, q, matched, score, exact, end_col, greedy, idx);
  };

  bool any = false;
  for (int q = tb.q0 + threadIdx.x; q < tb.q1; q += blockDim.x)
    any = any || tb.alive(q, a.scalars, a.flags, a.n_groups);
  if (threadIdx.x == 0) s_cols = 0;
  if (!__syncthreads_or(any)) {
    // no query keeps the group alive: nothing to read
    for (int q = tb.q0; q < tb.q1; ++q) emit(tb.slot, q, 0, 0, 0, 0, 0, -1);
    return;
  }
  // stage the tile; while its copies fly, order its rows by length, and
  // walk row ``r`` of it
  const int own_len = min(a.nuT[tb.slot], a.W);
  frizbee::stage_tile(s_tile, &s_cols, a.cpT, a.ctxT, tb, a.W,
                      UNICODE ? 4 : 1, own_len, a.W);
  const int r = frizbee::sort_rows_by_length(s_key, own_len);
  frizbee::stage_wait();
  __syncthreads();
  const long long slot = (long long)tb.slot - (int)threadIdx.x + r;
  const int nu = a.nuT[slot];
  const int len = min(nu, a.W);
  const int idx = a.keys_out != nullptr ? a.idxT[slot] : -1;
  const TileRow<UNICODE> row(s_tile, a.W, r);
  row.prepare(len, a.ctxT != nullptr);
  const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
  const int ge = sc.gap_ext, geo = sc.gap_ext + gop_extra;

  const int nq = tb.q1 - tb.q0;  // <= kMaxBlockQueries
  const unsigned alive_mask = frizbee::stage_needles(
      s_needle, &s_alive, a.scalars, a.flags, tb, a.n_groups, N);
  for (int qi = 0; qi < nq; ++qi) {
    const int q = tb.q0 + qi;
    if (!((alive_mask >> qi) & 1u)) {
      emit(slot, q, 0, 0, 0, 0, 0, -1);
      continue;
    }
    const int* nd = s_needle[qi];
    int orig[N], flip[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      orig[k] = nd[k];
      flip[k] = nd[kColstreamNeedle + k];
    }

    // ---- pass 1: positional prefilter
    const Window win = prefilter<N, UNICODE>(row, len, orig, flip, nd, a.pf_mode, a.T);
    const bool pf_matched = win.matched;
    const int wstart_raw = win.wstart_raw, wend = win.wend, nb = win.nb,
              jf = win.jf;
    const bool one_before = win.one_before;
    if (!pf_matched) {
      emit(slot, q, 0, 0, 0, 0, 0, idx);
      continue;
    }

    // ---- pass 2: affine-gap SW over the start-1-trimmed window. Its
    // first unit is the one at or past byte wstart: the unit before the
    // first hit when that unit is one byte long (always, on a byte
    // row), else the first hit's
    const int wstart = max(wstart_raw - 1, 0);
    const bool include_exact = wstart == 0 && wend == nb;
    int j = 0, boff = 0;
    if (wstart_raw > 0) {
      j = one_before ? jf - 1 : jf;
      boff = one_before ? wstart_raw - 1 : wstart_raw;
    }
    int h[N];
    bool pocc[N];  // the previous column's unit matches
#pragma unroll
    for (int k = 0; k < N; ++k) {
      h[k] = 0;
      pocc[k] = false;
    }
    int best = 0, end_b = 0;
    bool first = true;
    for (; j < len; ++j) {
      const int c = row.unit(j);
      const int bl = row.blen(j);
      if (boff + bl > wend) break;
      int bonus = 0;
      if (first) {
        if (wstart == 0) bonus = sc.prefix;
        first = false;
      } else {
        bonus = row.bonus(j, sc);
      }
      const int base_hit = sc.match + bonus;
      const int case_hit = base_hit + sc.case_b;
      // unit 0: no diagonal or up source
      const bool eq0 = c == orig[0];
      const bool occ0 = eq0 | (c == flip[0]);
      int cur = max(occ0 ? (eq0 ? case_hit : base_hit) : 0,
                    h[0] - (pocc[0] ? geo : ge));
      int diag_in = h[0];
      int g_up = occ0 ? -geo : -ge;  // the up move's gap after unit k-1
      h[0] = cur;
      pocc[0] = occ0;
      // unit k: max(diag_in + (hit or -mismatch), cur[k-1] - gap,
      // h[k] - gap, 0): the relu stands in for both the diagonal's
      // mismatch floor and the up move's (two DPX add-max)
#pragma unroll
      for (int k = 1; k < N; ++k) {
        const bool eq = c == orig[k];
        const bool occ = eq | (c == flip[k]);
        const int d = occ ? (eq ? case_hit : base_hit) : -sc.mismatch;
        const int left = h[k] - (pocc[k] ? geo : ge);
        cur = __viaddmax_s32_relu(diag_in, d, __viaddmax_s32(cur, g_up, left));
        diag_in = h[k];
        h[k] = cur;
        pocc[k] = occ;
        g_up = occ ? -geo : -ge;
      }
      if (cur > best) { best = cur; end_b = boff; }  // unit n-1's cell
      boff += bl;
    }
    // exact: the row equals the needle's original units
    bool eq = nu == N;
    if (eq) {
#pragma unroll
      for (int k = 0; k < N; ++k) eq = eq && (row.unit(k) == orig[k]);
    }
    int score = best;
    const int end_col = score > 0 ? end_b : wstart;
    const int exact = (include_exact && eq) ? 1 : 0;
    if (exact) score = min(score + sc.exact, 0xFFFF);
    emit(slot, q, 1, score, exact, end_col,
         (wend - wstart) > kMaxHaystackLen ? 1 : 0, idx);
  }
}

// The int16-lane instantiation (byte rows): two rows a thread. A block of
// ``half`` threads stages a tile of 2 x half rows (tile_geometry with two
// rows a thread) and sorts them by length; thread t walks the rows at
// sorted positions 2t and 2t + 1, so the two halves of its registers hold
// rows of about one length. Pass 1 runs per row as in the kernel above,
// one row after the other (one walk stepping both rows, and a byte table
// of the context facts, measured no faster on an H100: PERF.md). Pass 2
// runs the pair in the s16x2 halves of 32-bit registers (lanes16.cuh)
// over the union of the two trimmed windows: each half takes the needle
// masks of its byte only inside its own window, its own first column and
// context bonus, and its own best and end column (best2); a half the
// prefilter rejected takes none. The needle masks come from a 256-entry
// table a query (bits 0-15 the units a byte matches, 16-31 those it
// equals), built by the block before its pass 1 (a table a warp, built
// only where the warp has a pass 2 to run, measured slower): two lookups
// and two prmt a column give the pair's packed bits, and a unit's half
// masks cost one shift and one prmt each. The DP cell is three DPX
// add-max for both rows.
template <int N>
__global__ void __launch_bounds__(frizbee::kTileMaxRows, kMinBlocks<N>)
    colstream_fuzzy_pairs_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ int s_cols;
  __shared__ unsigned s_alive;
  __shared__ int s_key[2 * frizbee::kTileMaxRows];
  __shared__ int s_needle[kMaxBlockQueries][2 * kColstreamNeedle];
  // the byte table of the query: bits 0-15 the units a byte matches,
  // 16-31 those it equals
  __shared__ uint32_t s_masks[256];
  const int half = blockDim.x, rows = 2 * half;
  const TileBlock tb(a.chunks, a.qper, a.Q, rows);
  const long long total = (long long)a.n_groups * kGroupRows;
  const Scoring& sc = a.sc;

  bool any = false;
  for (int q = tb.q0 + threadIdx.x; q < tb.q1; q += blockDim.x)
    any = any || tb.alive(q, a.scalars, a.flags, a.n_groups);
  if (threadIdx.x == 0) s_cols = 0;
  if (!__syncthreads_or(any)) {
    // no query keeps the group alive: nothing to read
    for (int q = tb.q0; q < tb.q1; ++q) {
      emit_row(a, total, tb.slot, q, 0, 0, 0, 0, 0, -1);
      emit_row(a, total, tb.slot + half, q, 0, 0, 0, 0, 0, -1);
    }
    return;
  }
  // stage the tile (this thread's rows t and t + half); while its copies
  // fly, pair its rows by length
  const int own0 = min(a.nuT[tb.slot], a.W), own1 = min(a.nuT[tb.slot + half], a.W);
  frizbee::stage_tile(s_tile, &s_cols, a.cpT, nullptr, tb, a.W, 1, max(own0, own1),
                      a.W, rows);
  frizbee::sort_row_pairs_by_length(s_key, own0, own1);
  frizbee::stage_wait();
  __syncthreads();
  const int r0 = s_key[2 * threadIdx.x] & 0xFF, r1 = s_key[2 * threadIdx.x + 1] & 0xFF;
  const long long tile0 = (long long)tb.slot - (int)threadIdx.x;
  const long long slot0 = tile0 + r0, slot1 = tile0 + r1;
  const int nu0 = a.nuT[slot0], nu1 = a.nuT[slot1];
  const int len0 = min(nu0, a.W), len1 = min(nu1, a.W);
  const int idx0 = a.keys_out != nullptr ? a.idxT[slot0] : -1;
  const int idx1 = a.keys_out != nullptr ? a.idxT[slot1] : -1;
  const TileRow<false> row0(s_tile, a.W, r0, rows), row1(s_tile, a.W, r1, rows);
  const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
  const int mis = min(sc.mismatch, frizbee::kInt16ScoreLimit);
  const uint32_t nge = frizbee::pack2(-sc.gap_ext, -sc.gap_ext);
  const uint32_t ngeo =
      frizbee::pack2(-(sc.gap_ext + gop_extra), -(sc.gap_ext + gop_extra));
  const uint32_t neg_mm = frizbee::pack2(-mis, -mis);

  const int nq = tb.q1 - tb.q0;  // <= kMaxBlockQueries
  const unsigned alive_mask = frizbee::stage_needles(
      s_needle, &s_alive, a.scalars, a.flags, tb, a.n_groups, N);
  for (int qi = 0; qi < nq; ++qi) {
    const int q = tb.q0 + qi;
    if (!((alive_mask >> qi) & 1u)) {
      emit_row(a, total, slot0, q, 0, 0, 0, 0, 0, -1);
      emit_row(a, total, slot1, q, 0, 0, 0, 0, 0, -1);
      continue;
    }
    const int* nd = s_needle[qi];
    int orig[N], flip[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      orig[k] = nd[k];
      flip[k] = nd[kColstreamNeedle + k];
    }
    // the query's byte table; the previous query's readers are done
    __syncthreads();
    for (int c = threadIdx.x; c < 256; c += half) {
      uint32_t occ = 0, eq = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (c == orig[k]) eq |= 1u << k;
        if (c == orig[k] || c == flip[k]) occ |= 1u << k;
      }
      s_masks[c] = occ | (eq << 16);
    }
    __syncthreads();

    // ---- pass 1, a row at a time
    const Window w0 = prefilter<N, false>(row0, len0, orig, flip, nd, a.pf_mode, a.T);
    const Window w1 = prefilter<N, false>(row1, len1, orig, flip, nd, a.pf_mode, a.T);
    if (!w0.matched) emit_row(a, total, slot0, q, 0, 0, 0, 0, 0, idx0);
    if (!w1.matched) emit_row(a, total, slot1, q, 0, 0, 0, 0, 0, idx1);
    if (!w0.matched && !w1.matched) continue;

    // ---- pass 2, the pair: start-1-trimmed windows [ws, we) in columns
    // (a byte row's bytes); a rejected half has none
    const int ws0 = max(w0.wstart_raw - 1, 0), we0 = w0.matched ? w0.wend : 0;
    const int ws1 = max(w1.wstart_raw - 1, 0), we1 = w1.matched ? w1.wend : 0;
    int jlo = a.W, jhi = 0;
    if (ws0 < we0) { jlo = ws0; jhi = we0; }
    if (ws1 < we1) { jlo = min(jlo, ws1); jhi = max(jhi, we1); }
    uint32_t h[N];
#pragma unroll
    for (int k = 0; k < N; ++k) h[k] = 0;
    uint32_t pocc = 0;  // the previous column's unit matches, packed
    uint32_t best = 0;
    int end0 = 0, end1 = 0;
    for (int j = jlo; j < jhi; ++j) {
      const bool a0 = j >= ws0 && j < we0, a1 = j >= ws1 && j < we1;
      const int c0 = row0.unit(j), c1 = row1.unit(j);
      const uint32_t t0 = a0 ? s_masks[c0] : 0u, t1 = a1 ? s_masks[c1] : 0u;
      const uint32_t occ = frizbee::pair16(t0, t1), eqw = frizbee::pair16_high(t0, t1);
      // each half's bonus: the prefix bonus (or none) on its window's
      // first column, else the context bonus after the byte before
      int b0 = 0, b1 = 0;
      if (a0) b0 = j == ws0 ? (ws0 == 0 ? sc.prefix : 0) : row0.bonus(j, sc);
      if (a1) b1 = j == ws1 ? (ws1 == 0 ? sc.prefix : 0) : row1.bonus(j, sc);
      const uint32_t base_hit = frizbee::pack2(sc.match + b0, sc.match + b1);
      const uint32_t case_hit =
          frizbee::pack2(sc.match + sc.case_b + b0, sc.match + sc.case_b + b1);
      // unit 0: no diagonal or up source
      uint32_t mo = frizbee::half_masks16(occ, 0);
      uint32_t cur = __viaddmax_s16x2(
          h[0], frizbee::sel2(frizbee::half_masks16(pocc, 0), ngeo, nge),
          frizbee::hit2(mo, frizbee::half_masks16(eqw, 0), case_hit, base_hit, 0u));
      uint32_t diag_in = h[0];
      uint32_t gu = frizbee::sel2(mo, ngeo, nge);
      h[0] = cur;
#pragma unroll
      for (int k = 1; k < N; ++k) {
        mo = frizbee::half_masks16(occ, k);
        const uint32_t d = frizbee::hit2(mo, frizbee::half_masks16(eqw, k), case_hit,
                                         base_hit, neg_mm);
        cur = frizbee::cell2(diag_in, d, cur, gu, h[k],
                             frizbee::sel2(frizbee::half_masks16(pocc, k), ngeo, nge));
        diag_in = h[k];
        h[k] = cur;
        gu = frizbee::sel2(mo, ngeo, nge);
      }
      // unit n-1's cell, inside each half's window, against its best
      int raised;
      best = frizbee::best2(best, cur & ((a0 ? 0xFFFFu : 0u) | (a1 ? 0xFFFF0000u : 0u)),
                            &raised);
      if (raised & 1) end0 = j;
      if (raised & 2) end1 = j;
      pocc = occ;
    }
    // each matched half's outputs, unpacked to 32 bits
    auto finish = [&](const Window& w, const TileRow<false>& row, int nu, long long slot,
                      int idx, int ws, int score, int end) {
      bool eq = nu == N;
      if (eq) {
#pragma unroll
        for (int k = 0; k < N; ++k) eq = eq && (row.unit(k) == orig[k]);
      }
      const int end_col = score > 0 ? end : ws;
      const int exact = (ws == 0 && w.wend == w.nb && eq) ? 1 : 0;
      if (exact) score = min(score + sc.exact, 0xFFFF);
      emit_row(a, total, slot, q, 1, score, exact, end_col,
               (w.wend - ws) > kMaxHaystackLen ? 1 : 0, idx);
    };
    if (w0.matched) finish(w0, row0, nu0, slot0, idx0, ws0, frizbee::lo16(best), end0);
    if (w1.matched) finish(w1, row1, nu1, slot1, idx1, ws1, frizbee::hi16(best), end1);
  }
}

template <int N>
int launch(bool unicode, bool pairs, const frizbee::TileGeometry& geo,
           cudaStream_t stream, const Args& a) {
  auto kernel = pairs     ? colstream_fuzzy_pairs_kernel<N>
                : unicode ? colstream_fuzzy_kernel<N, true>
                          : colstream_fuzzy_kernel<N, false>;
  if (geo.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<geo.tiles * geo.chunks, geo.rows, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Shapes: cpT (n_groups*W*1024) int8
// bytes, or int32 codepoints when unicode != 0 (16-byte aligned); ctxT
// (n_groups*W*1024) int8 ctx plane or null (codepoints only; null derives
// the facts); nuT/idxT (n_groups*1024) int32, scalars (Q, 130) int32,
// flags (Q, n_groups) int32 or null, scoring (9,) host int32. Writes
// keys_out (Q, n_groups*1024) int64 when non-null (idxT required), else
// cols_out (5, Q, n_groups*1024) int32 = matched, score, exact, end_col,
// greedy. int16_lanes != 0 runs the int16-lane instantiation (byte rows;
// the caller has checked the scoring against score_fits_int16). Returns
// the error of the shared-memory opt-in, else cudaGetLastError() after the
// launch.
extern "C" int colstream_fuzzy_launch(
    const void* cpT, const void* ctxT, const void* nuT, const void* scalars,
    const void* flags, const void* idxT, int Q, int n_groups, int W, int n,
    int unicode, int int16_lanes, int T, int pf_mode, const void* scoring,
    int idx_bits, void* keys_out, void* cols_out, void* stream) {
  if (n_groups == 0 || Q == 0) return 0;
  if (n < 1 || n > kColstreamNeedle || W < 1 || W > kMaxHaystackLen ||
      (pf_mode == kPfDp && (T < 1 || T > 3)) ||
      (keys_out != nullptr && idxT == nullptr) ||
      (ctxT != nullptr && unicode == 0) || (int16_lanes != 0 && unicode != 0))
    return (int)cudaErrorInvalidValue;
  const bool u = unicode != 0, pairs = int16_lanes != 0;
  const frizbee::TileGeometry geo = frizbee::tile_geometry(
      W, u ? 5 : 1, n_groups, Q, pairs ? 2 : 1);
  const Args a{cpT, static_cast<const int8_t*>(ctxT),
               static_cast<const int*>(nuT), static_cast<const int*>(scalars),
               static_cast<const int*>(flags), static_cast<const int*>(idxT),
               n_groups, W, Q, geo.qper, geo.chunks, T, pf_mode,
               frizbee::scoring_from(scoring), idx_bits,
               static_cast<long long*>(keys_out), static_cast<int*>(cols_out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define CASE(NN) \
    case NN: return launch<NN>(u, pairs, geo, st, a);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
