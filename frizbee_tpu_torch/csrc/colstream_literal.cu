// Column-stream literal match (exact, prefix, suffix, substring) for Hopper
// (sm_90a): byte corpora and codepoint (unicode) corpora.
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py
// match_units_colstream in a literal mode (body _literal_block, key
// packing pack_keys, dead-group sentinels), both of its unit branches.
//
// Layout, tile and grid are those of colstream_fuzzy.cu
// (colstream_tile.cuh): a block stages the columns of a tile of rows of
// one group in shared memory once, with 16-byte cp.async copies, computes
// a codepoint row's class bytes (context bonus, byte length) once, and
// walks each row from there for every query of its chunk whose group is
// alive; a tile no query keeps alive reads nothing and writes sentinels.
// EXACT and PREFIX runs complete by column n-1, so those modes stage and
// walk n columns; the other modes sort a byte tile's rows by length
// first, so each warp walks rows of about one length.
//
// The walk is a bitap (LiteralRun): D[k] says "needle units 0..k match
// the columns ending here", S[k] holds that run's bonus + matching-case
// sum and, on a codepoint row, SB[k] its start byte. All are registers,
// unrolled by the template on n <= 16; needles of up to 4 units walk two
// queries in one pass over the row, sharing each column's unit, bonus and
// byte offset. A run completing at
// column j scores n*match + S[n-1], plus the exact bonus when it covers
// the whole row, clamped to u16; a strict > keeps the earliest best run,
// and end_col is its start byte plus the needle's bytes minus 1. SUFFIX
// selects only the run ending at the row's last unit. A codepoint row
// whose best run starts at unit 0 in a short mode sums the byte lengths of
// the rest of its row for the exact flag, reading them in device memory
// (past the staged columns). A row's outputs depend only on its own
// columns [0, min(nu, W)), so each thread stops at its own length (the TPU
// kernel walks the group maximum; the outputs are equal).
//
// Bound on this card: integer operations, 7 a (column, needle unit) cell
// (2 compares, or, and, 2 selects and an add) and 8 a column (the bonus,
// the case bonus, the prefix select, the completion test, the loop),
// against one read of each needed corpus unit (1 byte, or 4 bytes and the
// 1-byte ctx plane for codepoints) and one 8-byte key written per row and
// query. The completion test's branch (the score, the mode's selection)
// runs only where a whole run ends.

#include "colstream_tile.cuh"

namespace {

using frizbee::codepoint_ctx;
using frizbee::ctx_blen;
using frizbee::kColstreamNeedle;
using frizbee::kGroupRows;
using frizbee::kMaxBlockQueries;
using frizbee::Scoring;
using frizbee::TileBlock;
using frizbee::TileRow;

// modes, in the order of ops/literal.LITERAL_MODES
enum Mode { kExact = 0, kPrefix = 1, kSuffix = 2, kSubstring = 3 };

struct Args {
  const void* cpT;
  const int8_t* ctxT;
  const int *nuT, *scalars, *flags, *idxT;
  int n_groups, W, Q, qper, chunks, mode, nbl;
  Scoring sc;
  int idx_bits;
  long long* keys_out;
  int* cols_out;
};

// needles shorter than this walk two queries at once: their run state
// fits the registers twice, and the pair shares each column's unit, bonus
// and byte offset
constexpr int kPairedFrom = 5;

// One query's bitap over a row: D[k] says "needle units 0..k match the
// columns ending here", S[k] holds that run's bonus + matching-case sum
// and, on a codepoint row, SB[k] its start byte; best, b_start and b_p0
// the best complete run so far.
template <int N, bool UNICODE>
struct LiteralRun {
  int orig[N], flip[N];
  bool D[N];
  int S[N], SB[N];
  int best, b_start, b_p0;

  __device__ __forceinline__ void init(const int* nd) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      orig[k] = nd[k];
      flip[k] = nd[kColstreamNeedle + k];
      D[k] = false;
      S[k] = SB[k] = 0;
    }
    best = -1;
    b_start = b_p0 = 0;
  }

  // column j: unit c at byte boff, bonus hb (hbc in the original case)
  __device__ __forceinline__ void step(int c, int hb, int hbc, int j, int boff,
                                       int nu, int mode, const Scoring& sc) {
    // descending k reads the previous column's D[k-1], S[k-1] and
    // SB[k-1] before they are overwritten
#pragma unroll
    for (int k = N - 1; k >= 1; --k) {
      const bool eq_o = c == orig[k];
      const bool run = (eq_o || c == flip[k]) && D[k - 1];
      S[k] = run ? S[k - 1] + (eq_o ? hbc : hb) : 0;
      if (UNICODE) SB[k] = run ? SB[k - 1] : 0;
      D[k] = run;
    }
    {
      const bool eq_o = c == orig[0];
      const bool run = eq_o || c == flip[0];
      S[0] = run ? (eq_o ? hbc : hb) : 0;
      if (UNICODE) SB[0] = run ? boff : 0;
      D[0] = run;
    }
    if (D[N - 1]) {
      // a run of the whole needle ends at column j
      const bool at_p0 = j == N - 1;
      const int cand = min(
          N * sc.match + S[N - 1] + ((at_p0 && nu == N) ? sc.exact : 0), 0xFFFF);
      bool sel = true;
      if (mode == kExact) {
        sel = at_p0 && nu == N;
      } else if (mode == kPrefix) {
        sel = at_p0;
      } else if (mode == kSuffix) {
        sel = j == nu - 1;
      }
      if (sel && cand > best) {
        best = cand;
        b_start = UNICODE ? SB[N - 1] : j - (N - 1);
        b_p0 = at_p0 ? 1 : 0;
      }
    }
  }
};

template <int N, bool UNICODE>
__global__ void __launch_bounds__(frizbee::kTileMaxRows)
    colstream_literal_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ int s_cols;
  __shared__ unsigned s_alive;
  __shared__ int s_key[frizbee::kTileMaxRows];
  __shared__ int s_needle[kMaxBlockQueries][2 * kColstreamNeedle];
  const TileBlock tb(a.chunks, a.qper, a.Q);
  const long long total = (long long)a.n_groups * kGroupRows;
  const Scoring& sc = a.sc;
  const int mode = a.mode;

  // the outputs of row slot ``at`` for query q
  auto emit = [&](long long at, int q, int matched, int score, int exact,
                  int end_col, int idx) {
    const long long o = (long long)q * total + at;
    if (a.keys_out != nullptr) {
      a.keys_out[o] =
          frizbee::pack_key(matched, score, exact, end_col, 0, idx, a.idx_bits);
    } else {
      const long long plane = (long long)a.Q * total;
      a.cols_out[o] = matched;
      a.cols_out[o + plane] = score;
      a.cols_out[o + 2 * plane] = exact;
      a.cols_out[o + 3 * plane] = end_col;
      a.cols_out[o + 4 * plane] = 0;  // literal runs never take greedy
    }
  };

  bool any = false;
  for (int q = tb.q0 + threadIdx.x; q < tb.q1; q += blockDim.x)
    any = any || tb.alive(q, a.scalars, a.flags, a.n_groups);
  if (threadIdx.x == 0) s_cols = 0;
  if (!__syncthreads_or(any)) {
    // no query keeps the group alive: nothing to read
    for (int q = tb.q0; q < tb.q1; ++q) emit(tb.slot, q, 0, 0, 0, 0, -1);
    return;
  }
  // EXACT and PREFIX runs complete by column n-1: those modes stage and
  // walk n columns. Stage the tile; while its copies fly, order the rows
  // of a byte tile walked to their ends by length, and walk row ``r`` of
  // it (a codepoint tile keeps its order: its 4-byte units then sit in
  // distinct banks across a warp)
  const bool short_mode = mode == kExact || mode == kPrefix;
  const int own_len = min(a.nuT[tb.slot], a.W);
  frizbee::stage_tile(s_tile, &s_cols, a.cpT, a.ctxT, tb, a.W,
                      UNICODE ? 4 : 1, own_len,
                      short_mode ? N : a.W);
  const int r = (UNICODE || short_mode)
                    ? (int)threadIdx.x
                    : frizbee::sort_rows_by_length(s_key, own_len);
  frizbee::stage_wait();
  __syncthreads();
  const long long slot = (long long)tb.slot - (int)threadIdx.x + r;
  const int nu = a.nuT[slot];
  const int len = min(nu, a.W);
  const int idx = a.keys_out != nullptr ? a.idxT[slot] : -1;
  const int bound = short_mode ? min(len, N) : len;
  const TileRow<UNICODE> row(s_tile, a.W, r);
  row.prepare(bound, a.ctxT != nullptr);

  const int nq = tb.q1 - tb.q0;  // <= kMaxBlockQueries
  const unsigned alive_mask = frizbee::stage_needles(
      s_needle, &s_alive, a.scalars, a.flags, tb, a.n_groups, N);
  for (int qi = 0; qi < nq; ++qi)
    if (!((alive_mask >> qi) & 1u)) emit(slot, tb.q0 + qi, 0, 0, 0, 0, -1);

  // a walked query's result: boff is the byte count of columns
  // [0, bound)
  auto finish = [&](int qi, const LiteralRun<N, UNICODE>& run, int boff) {
    const int q = tb.q0 + qi;
    if (run.best < 0) {
      emit(slot, q, 0, 0, 0, 0, idx);
      return;
    }
    // the row's byte count: its unit count, or a codepoint row's byte
    // sum (only a run at unit 0 can be exact); past the short modes'
    // staged columns it reads the ctx plane (or the codepoints) in
    // device memory
    int nb = len;
    if (UNICODE && run.b_p0) {
      nb = boff;
      const long long base = ((long long)tb.g * a.W) * kGroupRows + tb.r0 + r;
      for (int j = bound; j < len; ++j) {
        const long long i = base + (long long)j * kGroupRows;
        nb += ctx_blen(a.ctxT != nullptr
                           ? (int)(uint8_t)a.ctxT[i]
                           : codepoint_ctx(static_cast<const int*>(a.cpT)[i]));
      }
    }
    emit(slot, q, 1, run.best, (run.b_p0 && nb == a.nbl) ? 1 : 0,
         min(run.b_start + a.nbl - 1, 0xFFFF), idx);
  };

  // the alive queries, two at a time for short needles (the mask is the
  // block's, so every thread takes the same turns)
  unsigned todo = alive_mask;
  while (todo != 0u) {
    const int qa = __ffs(todo) - 1;
    todo &= todo - 1u;
    if (N < kPairedFrom && todo != 0u) {
      const int qb = __ffs(todo) - 1;
      todo &= todo - 1u;
      LiteralRun<N, UNICODE> ra, rb;
      ra.init(s_needle[qa]);
      rb.init(s_needle[qb]);
      int boff = 0;
      for (int j = 0; j < bound; ++j) {
        const int c = row.unit(j);
        const int hb = j == 0 ? sc.prefix : row.bonus(j, sc);
        const int hbc = hb + sc.case_b;  // the unit in its original case
        ra.step(c, hb, hbc, j, boff, nu, mode, sc);
        rb.step(c, hb, hbc, j, boff, nu, mode, sc);
        if (UNICODE) boff += row.blen(j);
      }
      finish(qa, ra, boff);
      finish(qb, rb, boff);
    } else {
      LiteralRun<N, UNICODE> ra;
      ra.init(s_needle[qa]);
      int boff = 0;
      for (int j = 0; j < bound; ++j) {
        const int c = row.unit(j);
        const int hb = j == 0 ? sc.prefix : row.bonus(j, sc);
        ra.step(c, hb, hb + sc.case_b, j, boff, nu, mode, sc);
        if (UNICODE) boff += row.blen(j);
      }
      finish(qa, ra, boff);
    }
  }
}

template <int N>
int launch(bool unicode, const frizbee::TileGeometry& geo, cudaStream_t stream,
           const Args& a) {
  auto kernel = unicode ? colstream_literal_kernel<N, true>
                        : colstream_literal_kernel<N, false>;
  if (geo.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<geo.tiles * geo.chunks, geo.rows, geo.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Shapes as colstream_fuzzy_launch:
// cpT (n_groups*W*1024) int8 bytes or int32 codepoints (unicode != 0;
// 16-byte aligned), ctxT the int8 ctx plane or null, nuT/idxT
// (n_groups*1024) int32, scalars (Q, 130) int32, flags (Q, n_groups) int32
// or null, scoring (9,) host int32; mode 0..3 = exact, prefix, suffix,
// substring; nbl = the needle's byte length. Writes keys_out (Q,
// n_groups*1024) int64 when non-null, else cols_out (5, Q, n_groups*1024)
// int32. Returns the error of the shared-memory opt-in, else
// cudaGetLastError() after the launch.
extern "C" int colstream_literal_launch(
    const void* cpT, const void* ctxT, const void* nuT, const void* scalars,
    const void* flags, const void* idxT, int Q, int n_groups, int W, int n,
    int unicode, int mode, int nbl, const void* scoring, int idx_bits,
    void* keys_out, void* cols_out, void* stream) {
  if (n_groups == 0 || Q == 0) return 0;
  if (mode < kExact || mode > kSubstring || n < 1 || n > kColstreamNeedle ||
      W < 1 || W > frizbee::kMaxHaystackLen ||
      (keys_out != nullptr && idxT == nullptr) ||
      (ctxT != nullptr && unicode == 0))
    return (int)cudaErrorInvalidValue;
  const bool u = unicode != 0;
  const frizbee::TileGeometry geo = frizbee::tile_geometry(
      W, u ? 5 : 1, n_groups, Q);
  const Args a{cpT, static_cast<const int8_t*>(ctxT),
               static_cast<const int*>(nuT), static_cast<const int*>(scalars),
               static_cast<const int*>(flags), static_cast<const int*>(idxT),
               n_groups, W, Q, geo.qper, geo.chunks, mode, nbl,
               frizbee::scoring_from(scoring), idx_bits,
               static_cast<long long*>(keys_out), static_cast<int*>(cols_out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define CASE(NN) \
    case NN: return launch<NN>(u, geo, st, a);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
