// Column-stream literal match (exact, prefix, suffix, substring) for Hopper
// (sm_90a): byte corpora and codepoint (unicode) corpora.
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py
// match_units_colstream in a literal mode (body _literal_block, key
// packing pack_keys, dead-group sentinels), both of its unit branches.
//
// Layout and grid are those of colstream_fuzzy.cu: rows come in 1024-row
// groups, row r of group g at unit column j is element (g*W + j)*1024 + r
// of cpT (int8 bytes or int32 codepoints) and of the optional int8 ctx
// plane; one thread owns one row and walks its columns, blocks hold 128
// rows of one group and one query (grid = groups*8 x Q), so the stage-1
// flag test is uniform per block and a dead group writes sentinels at once.
//
// The walk is a bitap: D bit k says "needle units 0..k match the columns
// ending here", S[k] holds that run's bonus + matching-case sum and, on a
// codepoint row, SB[k] its start byte. All are registers (D one uint32,
// S[N] and SB[N] unrolled by the template on n <= 16). A run completing at
// column j scores n*match + S[n-1], plus the exact bonus when it covers
// the whole row, clamped to u16; a strict > keeps the earliest best run,
// and end_col is its start byte plus the needle's bytes minus 1. EXACT and
// PREFIX runs can complete only at column n-1, so those modes walk
// min(n, len) columns (a codepoint row whose best run starts at unit 0
// then sums the rest of its bytes for the exact flag); SUFFIX selects only
// the run ending at the row's last unit. A row's outputs depend only on
// its own columns [0, min(nu, W)), so each thread stops at its own length
// (the TPU kernel walks the group maximum; the outputs are equal).
//
// Bound on this card: ~8 int32 operations per (column, needle unit) cell
// plus ~12 per column for the bonus context, against one unit read per
// column (1 byte, or 4 bytes and the 1-byte ctx plane for codepoints) and
// one 8-byte key written per row and query. Short needles with group flags
// leave little DP, so at the serving shapes the key writes bound it
// (bytes). Left for later: scalar loads per thread.

#include "kernel_common.cuh"

namespace {

using frizbee::byte_ctx;
using frizbee::codepoint_ctx;
using frizbee::context_bonus;
using frizbee::ctx_blen;
using frizbee::kMaxNeedle;
using frizbee::Scoring;

constexpr int kGroupRows = 1024;
constexpr int kBlockRows = 128;

// modes, in the order of ops/literal.LITERAL_MODES
enum Mode { kExact = 0, kPrefix = 1, kSuffix = 2, kSubstring = 3 };

template <int N, bool UNICODE>
__global__ void __launch_bounds__(kBlockRows) colstream_literal_kernel(
    const void* __restrict__ cpT, const int8_t* __restrict__ ctxT,
    const int* __restrict__ nuT, const int* __restrict__ scalars,
    const int* __restrict__ flags, const int* __restrict__ idxT, int n_groups,
    int W, int mode, int nbl, Scoring sc, int idx_bits,
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

  int matched = 0, score = 0, exact = 0, end_col = 0;
  if (alive) {
    int orig[N], flip[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      orig[k] = scal[2 + k];
      flip[k] = scal[2 + kMaxNeedle + k];
    }
    const int nu = nuT[slot];
    const int len = min(nu, W);
    const int bound = (mode == kExact || mode == kPrefix) ? min(len, N) : len;
    const long long base = (long long)g * W * kGroupRows + r;
    const int8_t* col8 = static_cast<const int8_t*>(cpT) + base;
    const int* col32 = static_cast<const int*>(cpT) + base;
    const int8_t* ctx = ctxT != nullptr ? ctxT + base : nullptr;
    auto unit = [&](int j) -> int {
      return UNICODE ? col32[(long long)j * kGroupRows]
                     : (int)(uint8_t)col8[(long long)j * kGroupRows];
    };
    auto facts = [&](int j, int c) -> int {
      if (!UNICODE) return byte_ctx(c);
      if (ctx != nullptr) return (int)(uint8_t)ctx[(long long)j * kGroupRows];
      return codepoint_ctx(c);
    };

    unsigned D = 0;  // bit k: a run of needle units 0..k ends at column j-1
    int S[N];        // S[k]: bonus + matching-case sum of that run
    int SB[N];       // SB[k]: that run's start byte (codepoint rows)
#pragma unroll
    for (int k = 0; k < N; ++k) S[k] = SB[k] = 0;
    int best = -1, b_start = 0, b_p0 = 0, prev = 0, boff = 0;
    for (int j = 0; j < bound; ++j) {
      const int c = unit(j);
      const int f = facts(j, c);
      const int bonus = j == 0 ? sc.prefix : context_bonus(f, prev, sc);
      // descending k reads the previous column's D bit k-1, S[k-1] and
      // SB[k-1] before they are overwritten
      unsigned D_new = 0;
#pragma unroll
      for (int k = N - 1; k >= 1; --k) {
        const bool eq_o = c == orig[k];
        const bool run = (eq_o || c == flip[k]) && ((D >> (k - 1)) & 1u);
        S[k] = run ? S[k - 1] + bonus + (eq_o ? sc.case_b : 0) : 0;
        if (UNICODE) SB[k] = run ? SB[k - 1] : 0;
        D_new |= (run ? 1u : 0u) << k;
      }
      {
        const bool eq_o = c == orig[0];
        const bool run = eq_o || c == flip[0];
        S[0] = run ? bonus + (eq_o ? sc.case_b : 0) : 0;
        if (UNICODE) SB[0] = run ? boff : 0;
        D_new |= run ? 1u : 0u;
      }
      D = D_new;
      const bool at_p0 = j == N - 1;
      int cand = N * sc.match + S[N - 1] + ((at_p0 && nu == N) ? sc.exact : 0);
      cand = min(cand, 0xFFFF);
      bool sel = (D >> (N - 1)) & 1u;
      if (mode == kExact) {
        sel = sel && at_p0 && nu == N;
      } else if (mode == kPrefix) {
        sel = sel && at_p0;
      } else if (mode == kSuffix) {
        sel = sel && j == nu - 1;
      }
      if (sel && cand > best) {
        best = cand;
        b_start = UNICODE ? SB[N - 1] : j - (N - 1);
        b_p0 = at_p0 ? 1 : 0;
      }
      prev = f;
      if (UNICODE) boff += ctx_blen(f);
    }
    if (best >= 0) {
      matched = 1;
      score = best;
      end_col = min(b_start + nbl - 1, 0xFFFF);
      // the row's byte count: its unit count, or a codepoint row's byte
      // sum (walked on past the short modes' bound; only a run at unit 0
      // can be exact)
      int nb = len;
      if (UNICODE && b_p0) {
        nb = boff;
        for (int j = bound; j < len; ++j) nb += ctx_blen(facts(j, unit(j)));
      }
      exact = (b_p0 && nb == nbl) ? 1 : 0;
    }
  }

  if (keys_out != nullptr) {
    keys_out[out_i] = frizbee::pack_key(matched, score, exact, end_col, 0,
                                        alive ? idxT[slot] : -1, idx_bits);
  } else {
    const long long plane = (long long)gridDim.y * total;
    cols_out[out_i] = matched;
    cols_out[out_i + plane] = score;
    cols_out[out_i + 2 * plane] = exact;
    cols_out[out_i + 3 * plane] = end_col;
    cols_out[out_i + 4 * plane] = 0;  // literal runs never take greedy
  }
}

template <int N>
void launch(bool unicode, dim3 grid, cudaStream_t stream, const void* cpT,
            const int8_t* ctxT, const int* nuT, const int* scalars,
            const int* flags, const int* idxT, int n_groups, int W, int mode,
            int nbl, Scoring sc, int idx_bits, long long* keys_out,
            int* cols_out) {
  if (unicode) {
    colstream_literal_kernel<N, true><<<grid, kBlockRows, 0, stream>>>(
        cpT, ctxT, nuT, scalars, flags, idxT, n_groups, W, mode, nbl, sc,
        idx_bits, keys_out, cols_out);
  } else {
    colstream_literal_kernel<N, false><<<grid, kBlockRows, 0, stream>>>(
        cpT, nullptr, nuT, scalars, flags, idxT, n_groups, W, mode, nbl, sc,
        idx_bits, keys_out, cols_out);
  }
}

}  // namespace

// C entry point (bound with ctypes). Shapes as colstream_fuzzy_launch:
// cpT (n_groups*W*1024) int8 bytes or int32 codepoints (unicode != 0),
// ctxT the int8 ctx plane or null, nuT/idxT (n_groups*1024) int32, scalars
// (Q, 130) int32, flags (Q, n_groups) int32 or null, scoring (9,) host
// int32; mode 0..3 = exact, prefix, suffix, substring; nbl = the needle's
// byte length. Writes keys_out (Q, n_groups*1024) int64 when non-null,
// else cols_out (5, Q, n_groups*1024) int32. Returns cudaGetLastError().
extern "C" int colstream_literal_launch(
    const void* cpT, const void* ctxT, const void* nuT, const void* scalars,
    const void* flags, const void* idxT, int Q, int n_groups, int W, int n,
    int unicode, int mode, int nbl, const void* scoring, int idx_bits,
    void* keys_out, void* cols_out, void* stream) {
  const Scoring sc = frizbee::scoring_from(scoring);
  const dim3 grid(n_groups * (kGroupRows / kBlockRows), Q);
  if (n_groups == 0 || Q == 0) return 0;
  if (mode < kExact || mode > kSubstring) return (int)cudaErrorInvalidValue;
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
    case NN: launch<NN>(u, grid, st, cpT, x, b, c, d, e, n_groups, W, mode, nbl, sc, idx_bits, ko, co); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
