// Column-stream fused prefilter + Smith-Waterman, fuzzy mode, for Hopper
// (sm_90a): byte corpora and codepoint (unicode) corpora.
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py
// match_units_colstream (mode="fuzzy", body _match_block, key packing
// pack_keys, dead-group sentinels), both of its unit branches.
//
// Layout: rows come in 1024-row groups; row r of group g at unit column j
// is element (g*W + j)*1024 + r of cpT (int8 bytes, or int32 codepoints)
// and of the optional int8 ctx plane. One thread owns one row and walks its
// columns, so the 32 threads of a warp read 32 consecutive elements per
// column and every DP dependency (greedy embedding, minimal-position DP,
// the affine gap recurrence) is a plain loop-carried register. The
// per-needle-unit state (h[k], n <= 16) and the T+1 prefilter states are
// registers; the kernel is templated on n so those arrays unroll, and on
// the unit type. Blocks hold 128 rows of one group and one query (grid =
// groups*8 x Q), so the stage-1 flag test is uniform per block: a dead
// group writes sentinels and never runs the DP.
//
// Units and bytes. A byte row's window [start, end) and end_col are unit
// columns. A codepoint row's are UTF-8 byte offsets: each thread carries
// the byte offset of its current column and the row's byte count in
// registers (the TPU kernel's packed 14-bit window word is a workaround of
// its register allocator; plain registers here). A unit's bonus facts and
// byte length come from one int8 ctx-plane load (corpus.ctx_plane), or,
// without a plane, from the codepoint's UTF-8 lead and last byte.
//
// A row's outputs depend only on its own columns [0, min(nu, W)): the
// prefilter stops there, and the DP covers only the matched window (the
// start-1-trimmed byte window) — columns outside it are inactive in the
// Pallas body and leave best/end untouched, and the DP state before the
// window is all zeros. A byte row starts its DP walk at the window's first
// column; a codepoint row walks from column 0 to find it. The TPU kernel
// walks every row of a group to the group maximum instead (and codepoint
// rows there without the matched-hull bound); the outputs are equal.
// greedy flags a matched row whose trimmed window exceeds 1024 bytes.
//
// Bound on this card: integer ALU work per DP cell (~6 int ops per
// (column, needle unit) in the prefilter, ~14 in the DP), not bytes — the
// 1M-row int8 corpus is ~95 MB per query pass (4 + 1 bytes per unit for
// codepoints and their ctx plane). Left for later: scalar loads per thread
// (no vector loads or shared-memory staging of column tiles), and warps
// run to the longest of their 32 rows.

#include "kernel_common.cuh"

namespace {

using frizbee::byte_ctx;
using frizbee::codepoint_ctx;
using frizbee::context_bonus;
using frizbee::ctx_blen;
using frizbee::kMaxHaystackLen;
using frizbee::kMaxNeedle;
using frizbee::Scoring;

constexpr int kGroupRows = 1024;
constexpr int kBlockRows = 128;

enum PrefilterMode { kPfNone = 0, kPfGreedy = 1, kPfDp = 2 };

// One row's units: column j's value and its ctx facts (byte length, bonus
// bits). A byte is one byte long; a codepoint reads the ctx plane when one
// is given.
template <bool UNICODE>
struct RowUnits {
  const void* col;
  const int8_t* ctx;
  __device__ __forceinline__ int unit(int j) const {
    const long long i = (long long)j * kGroupRows;
    if (UNICODE) return static_cast<const int*>(col)[i];
    return (int)(uint8_t) static_cast<const int8_t*>(col)[i];
  }
  __device__ __forceinline__ int facts(int j, int c) const {
    if (!UNICODE) return byte_ctx(c);
    if (ctx != nullptr) return (int)(uint8_t)ctx[(long long)j * kGroupRows];
    return codepoint_ctx(c);
  }
  __device__ __forceinline__ int blen(int j, int c) const {
    return UNICODE ? ctx_blen(facts(j, c)) : 1;
  }
};

template <int N, bool UNICODE>
__global__ void __launch_bounds__(kBlockRows) colstream_fuzzy_kernel(
    const void* __restrict__ cpT, const int8_t* __restrict__ ctxT,
    const int* __restrict__ nuT, const int* __restrict__ scalars,
    const int* __restrict__ flags, const int* __restrict__ idxT, int n_groups,
    int W, int T, int pf_mode, Scoring sc, int idx_bits,
    long long* __restrict__ keys_out, int* __restrict__ cols_out) {
  const int q = blockIdx.y;
  const int slot = blockIdx.x * kBlockRows + threadIdx.x;
  const int g = slot / kGroupRows;
  const int r = slot % kGroupRows;
  const long long total = (long long)n_groups * kGroupRows;
  const long long out_i = (long long)q * total + slot;
  const int* scal = scalars + (long long)q * (2 + 2 * kMaxNeedle);

  bool alive = (long long)g * kGroupRows < scal[0];
  if (flags != nullptr) alive = alive && flags[(long long)q * n_groups + g] > 0;

  int matched = 0, score = 0, exact = 0, end_col = 0, greedy = 0;
  if (alive) {
    int orig[N], flip[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      orig[k] = scal[2 + k];
      flip[k] = scal[2 + kMaxNeedle + k];
    }
    const int nu = nuT[slot];
    const int len = min(nu, W);
    const long long base = (long long)g * W * kGroupRows + r;
    RowUnits<UNICODE> row;
    row.col = UNICODE ? (const void*)(static_cast<const int*>(cpT) + base)
                      : (const void*)(static_cast<const int8_t*>(cpT) + base);
    row.ctx = ctxT != nullptr ? ctxT + base : nullptr;

    // ---- pass 1: positional prefilter -> matched, byte window
    // [start, end), and the row's byte count nb
    bool pf_matched = true;
    int wstart_raw = 0, wend = 0, nb = len;
    if (pf_mode == kPfGreedy) {
      // greedy leftmost embedding; start = first hit of needle[0], end =
      // last occurrence of the final unit at or after completion
      int np = 0, sbyte = 0, ebyte = 0, boff = 0;
      bool ffound = false, efound = false;
      for (int j = 0; j < len; ++j) {
        const int c = row.unit(j);
        const int bl = row.blen(j, c);
        bool occ_np = false, hit0 = false, occ_last = false;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const bool o = (c == orig[k]) | (c == flip[k]);
          occ_np |= (np == k) & o;
          if (k == 0) hit0 = o;
          if (k == N - 1) occ_last = o;
        }
        if (!ffound && hit0) { ffound = true; sbyte = boff; }
        np += occ_np ? 1 : 0;
        if (occ_last && np >= N) { efound = true; ebyte = boff + bl; }
        boff += bl;
      }
      nb = boff;
      pf_matched = np >= N;
      wstart_raw = (pf_matched && ffound) ? sbyte : 0;
      wend = (pf_matched && efound) ? ebyte : nb;
    } else if (pf_mode == kPfDp) {
      // minimal-position DP: gs[t] = longest needle prefix embeddable with
      // <= t deletions; start = first occurrence among needle[0..=T], end =
      // last occurrence among the last T+1 units
      int gs[4] = {0, 1, 2, 3};
      int sbyte = 0, ebyte = 0, boff = 0;
      bool ffound = false, efound = false;
      for (int j = 0; j < len; ++j) {
        const int c = row.unit(j);
        const int bl = row.blen(j, c);
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
        if (!ffound && hit_low) { ffound = true; sbyte = boff; }
        if (hit_tail) { efound = true; ebyte = boff + bl; }
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
        for (int j = 0; j < len; ++j) nb += row.blen(j, row.unit(j));
      }
      wend = nb;
    }

    if (pf_matched) {
      // ---- pass 2: affine-gap SW over the start-1-trimmed window
      const int wstart = max(wstart_raw - 1, 0);
      const bool include_exact = wstart == 0 && wend == nb;
      const bool include_prefix = wstart == 0;
      const int gop_extra = max(sc.gap_open - sc.gap_ext, 0);
      int h[N];
#pragma unroll
      for (int k = 0; k < N; ++k) h[k] = 0;
      unsigned mm = 0;  // previous column's per-unit match flags
      int prev = 0, best = 0, end_b = 0;
      bool first = true;
      // a byte row's window starts at column wstart; a codepoint row
      // walks from column 0 to the first unit at or past byte wstart
      int boff = UNICODE ? 0 : wstart;
      for (int j = UNICODE ? 0 : wstart; j < len; ++j) {
        const int c = row.unit(j);
        const int f = row.facts(j, c);
        const int bl = UNICODE ? ctx_blen(f) : 1;
        if (boff + bl > wend) break;
        if (UNICODE && boff < wstart) {
          prev = f;
          boff += bl;
          continue;
        }
        int bonus = 0;
        if (first) {
          if (include_prefix) bonus = sc.prefix;
          first = false;
        } else {
          bonus = context_bonus(f, prev, sc);
        }
        int diag_in = 0, up_src = 0;
        bool mm_prev = false;
        unsigned mm_new = 0;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const bool occ = (c == orig[k]) | (c == flip[k]);
          const int hit = sc.match + bonus + (c == orig[k] ? sc.case_b : 0);
          const int left = h[k] - sc.gap_ext - (((mm >> k) & 1u) ? gop_extra : 0);
          int cur;
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
          mm_new |= (occ ? 1u : 0u) << k;
          if (k == N - 1 && cur > best) { best = cur; end_b = boff; }
        }
        mm = mm_new;
        prev = f;
        boff += bl;
      }
      // exact: the row equals the needle's original units
      bool eq = nu == N;
      if (eq) {
#pragma unroll
        for (int k = 0; k < N; ++k) eq = eq && (row.unit(k) == orig[k]);
      }
      matched = 1;
      score = best;
      end_col = score > 0 ? end_b : wstart;
      exact = (include_exact && eq) ? 1 : 0;
      if (exact) score = min(score + sc.exact, 0xFFFF);
      greedy = (wend - wstart) > kMaxHaystackLen ? 1 : 0;
    }
  }

  if (keys_out != nullptr) {
    keys_out[out_i] = frizbee::pack_key(matched, score, exact, end_col, greedy,
                                        alive ? idxT[slot] : -1, idx_bits);
  } else {
    const long long plane = (long long)gridDim.y * total;
    cols_out[out_i] = matched;
    cols_out[out_i + plane] = score;
    cols_out[out_i + 2 * plane] = exact;
    cols_out[out_i + 3 * plane] = end_col;
    cols_out[out_i + 4 * plane] = greedy;
  }
}

template <int N>
void launch(bool unicode, dim3 grid, cudaStream_t stream, const void* cpT,
            const int8_t* ctxT, const int* nuT, const int* scalars,
            const int* flags, const int* idxT, int n_groups, int W, int T,
            int pf_mode, Scoring sc, int idx_bits, long long* keys_out,
            int* cols_out) {
  if (unicode) {
    colstream_fuzzy_kernel<N, true><<<grid, kBlockRows, 0, stream>>>(
        cpT, ctxT, nuT, scalars, flags, idxT, n_groups, W, T, pf_mode, sc,
        idx_bits, keys_out, cols_out);
  } else {
    colstream_fuzzy_kernel<N, false><<<grid, kBlockRows, 0, stream>>>(
        cpT, nullptr, nuT, scalars, flags, idxT, n_groups, W, T, pf_mode, sc,
        idx_bits, keys_out, cols_out);
  }
}

}  // namespace

// C entry point (bound with ctypes). Shapes: cpT (n_groups*W*1024) int8
// bytes, or int32 codepoints when unicode != 0; ctxT (n_groups*W*1024) int8
// ctx plane or null (codepoints only; null derives the facts); nuT/idxT
// (n_groups*1024) int32, scalars (Q, 130) int32, flags (Q, n_groups) int32
// or null, scoring (9,) host int32. Writes keys_out (Q, n_groups*1024)
// int64 when non-null (idxT required), else cols_out (5, Q, n_groups*1024)
// int32 = matched, score, exact, end_col, greedy. Returns
// cudaGetLastError() after the launch.
extern "C" int colstream_fuzzy_launch(
    const void* cpT, const void* ctxT, const void* nuT, const void* scalars,
    const void* flags, const void* idxT, int Q, int n_groups, int W, int n,
    int unicode, int T, int pf_mode, const void* scoring, int idx_bits,
    void* keys_out, void* cols_out, void* stream) {
  const Scoring sc = frizbee::scoring_from(scoring);
  const dim3 grid(n_groups * (kGroupRows / kBlockRows), Q);
  if (n_groups == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(ctxT);
  const int* b = static_cast<const int*>(nuT);
  const int* c = static_cast<const int*>(scalars);
  const int* d = static_cast<const int*>(flags);
  const int* e = static_cast<const int*>(idxT);
  long long* ko = static_cast<long long*>(keys_out);
  int* co = static_cast<int*>(cols_out);
  const bool u = unicode != 0;
  switch (n) {
#define CASE(NN) \
    case NN: launch<NN>(u, grid, st, cpT, x, b, c, d, e, n_groups, W, T, pf_mode, sc, idx_bits, ko, co); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
