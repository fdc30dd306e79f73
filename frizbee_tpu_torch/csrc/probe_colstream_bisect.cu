// The stages of the reference's column-stream bisect probes, for Hopper
// (sm_90a): the colstream fuzzy kernel built up piece by piece, each stage
// writing five int32 planes.
//
// Replaces the Pallas kernels run by benchmarks/probe_colstream_bisect.py
// (run :41, pallas_call :42: stage_a :63, stage_b :88, stage_c :173,
// stage_c1 :236, stage_c2 :272) and benchmarks/probe_colstream_bisect2.py
// (run :35, pallas_call :36: make_stage(track_fstart, track_tail,
// out_carries) :57 over five combinations). There a grid step holds a
// group of 8 x 128 rows in vector registers and walks its W unit columns.
// The reference's block (nG * W, 8, 128) int32 is, with no copy, (nG, W,
// 1024): unit j of row i of group g at [g, j, i], so a column of a group is
// 1024 contiguous units; the unit counts (nG * 8, 128) are (nG, 1024).
//
// The stage is a template parameter, and each stage computes exactly what
// the reference's does, quirks included:
// - stage A: the plain affine recurrence over the needle (orig units only),
//   best from the last needle unit's cell; plane i is best + i.
// - stage B: the full SW pass with a trivial window [0, min(nu, W)): bonus
//   (capitalisation, delimiter, prefix), exact-case bonus, mismatch-gap
//   costs from the previous column's match bits (mm_bits), an unclamped
//   left move, the end column of the best cell, and the exact flag from
//   the first n units against scal[2 + j]; the previous-byte context reads
//   -1 on columns past the row (a valid column's previous last byte starts
//   at -1 and takes the first byte, 0 past the row).
// - the prefilter stages: the greedy embedding's advance, the first hit's
//   start and the tail's end, with the advance taken as the chain
//   (np == k) & occ_k (stage C, C2), any hit of the column (C1) or the first
//   unit's hit (the bisect2 stages), window tracking on or off, and the
//   carries or zeros in planes 2-4.
//
// Bound on this card: bytes or operations (the int32 work a (row, column,
// needle unit) cell and a (row, column) step take, counted in
// chip_smoke.py BISECT_OPS), against 4 bytes a unit read once, 4 bytes of
// unit count and 20 bytes of planes a row. The first design (v1 below, kept
// only for chip_smoke.py's A/B) ran a row a thread with one 4-byte load in
// flight and every compare of every cell on the int32 units, at 40-51% of
// the bound at 1M rows. This one (the design of probe_transposed.cu):
// - A block owns a tile of 512 rows of one group and streams its columns
//   through a shared-memory ring (column_ring.cuh: TMA bulk copies, 3
//   slots, 2 chunks in flight; chunks of 8 columns for A and B, 16 for the
//   prefilter stages); a thread walks two neighbouring rows, whose units
//   one 8-byte shared load reads.
// - The compares become shared tables the block writes first, an entry
//   for each unit value in [0, 256) and a no-unit entry that a column past
//   the row takes (so `valid` costs a select a row):
//   * A: a byte a needle unit, its diagonal operand + 6 (18 on a hit of
//     orig, 0 else); the pair's cells run as the transposed probe's, each
//     value + 64 in an unsigned 16-bit half (column_ring.cuh kBias), a
//     prmt for the operand, two packed adds and a 3-input DPX max a cell
//     (cells stay <= 12 n).
//   * B: a byte a needle unit for each of the four bonus classes (bonus 0,
//     4, 8 or 12: the prefix bonus on the first column, else 4 for a
//     capitalisation and 4 for a delimiter step), the diagonal operand + 6
//     (12 + bonus on a hit of either case, 4 more on an exact one, -6
//     else); and a byte a needle unit of the mismatch-gap cost + 5 (-5
//     after a hit, -1 else). A row's class is one lookup of its byte
//     classes and its predecessor's (a 9 x 8 table; row 8 stands before
//     column 0). In each half, + 64, the pair's cell is
//       t   = max(diag_in + d - 6, h[k] + l_k - 5, 0)
//       cur = max(up_src + g_{k-1} - 5, t)
//     with l_k the previous column's g_k: two prmt, three packed adds and
//     two 3-input max, the up move's serial chain an add and a max. A
//     hit's diag_in + d exceeds relu(diag_in - 6), a miss's is that relu
//     once 0 is in the max, so this is the reference's max of diag, up
//     and left. Cells stay <= 36 n <= 576 (a diagonal step adds at most 12
//     + 12 + 4 and cur >= 0), so no half leaves [0, 65536). The last
//     unit's best, its end column and the exact flag stay int32 a row.
//   * the prefilter stages: a word of the needle units a unit hits in
//     either case; the chain's advance is bit np of it, C1's any bit, the
//     bisect2 stages' bit 0, the tail bit n-1, and np and the carries stay
//     int32 a row (the compares of a column collapse into one lookup a
//     row, so no s16x2 is left to gain; comparing units 0 and n-1 directly
//     in the bisect2 stages measured slower). The first hit is a running
//     min of hit columns, the tail's end the last hit's.
//   Units outside [0, 256) take the no-unit entry when every needle unit
//   lies inside; else (a needle unit outside) the kernel walks a path
//   whose outside units compute their entries from the needle (exact for
//   every int32 unit).
// - Issue: the prmt and the max run on one pipe at 64 lanes an SM a clock
//   (as do DPX add-max and 32-bit max; measured, pipe_rates.py), the adds
//   on either integer pipe, so the packed cells keep the add-max work off
//   that pipe.

#include "column_ring.cuh"
#include "kernel_common.cuh"

namespace {

using frizbee::kMaxNeedle;

constexpr int kGroupRows = 8 * 128;  // rows of one colstream group
constexpr int kPlanes = 5;

// the stage ids of the C entry point, in the order of
// frizbee_tpu_torch/probes/colstream_bisect.py STAGES
enum Stage : int {
  kA,
  kB,
  kC,
  kC1,
  kC2,
  kFstartOutz,
  kTailOutz,
  kBothOutz,
  kNoneOutcarries,
  kBothOutcarries,
  kStages,
};

// how a prefilter stage advances its needle position np
enum Advance : int { kChain, kAny, kHit0 };

// the reference's delim: a byte (0..127) that is no letter and no digit;
// -1 (no previous unit) is none
__device__ __forceinline__ bool delim_byte(int b) { return b >= 0 && frizbee::is_delim(b); }


namespace v1 {

constexpr int kThreads = 256;

struct Row {
  const int* col;  // unit j at col[j * kGroupRows]
  int nu;
  int W;
  __device__ __forceinline__ int unit(int j) const {
    return __ldg(col + (long long)j * kGroupRows);
  }
};

template <int N>
__device__ __forceinline__ void stage_a(const Row& row, const int (&orig)[N],
                                        int (&o)[kPlanes]) {
  int h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) h[k] = 0;
  int best = 0;
  for (int j = 0; j < row.W; ++j) {
    const int hay = row.unit(j);
    const bool valid = row.nu > j;
    int diag_in = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool occ = valid && hay == orig[k];
      const int diag = occ ? diag_in + 12 : max(diag_in - 6, 0);
      const int cur = max(diag, max(h[k] - 1, 0));
      diag_in = h[k];
      h[k] = cur;
    }
    best = max(best, h[N - 1]);
  }
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) o[i] = best + i;
}

template <int N>
__device__ __forceinline__ void stage_b(const Row& row, const int* scal,
                                        const int (&orig)[N], const int (&flip)[N],
                                        int (&o)[kPlanes]) {
  const int nuv = row.nu;
  const int wstart = 0;
  const int wend = min(nuv, row.W);
  const int nb = wend;
  const bool include_exact = wstart == 0 && wend == nb;
  const bool include_prefix = wstart == 0;
  int h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) h[k] = 0;
  int mm_bits = 0, boff = 0, prev_last = -1, seen_first = 0, best = 0, end_b = 0, neq = 0;
  for (int j = 0; j < row.W; ++j) {
    const int hay = row.unit(j);
    const bool valid = nuv > j;
    const int first = valid ? hay : 0;
    const int last = first;
    const int blen = valid ? 1 : 0;
    const bool active = valid && boff >= wstart && boff + blen <= wend;
    const bool is_first = active && seen_first == 0;
    seen_first |= active ? 1 : 0;
    const int pb = valid ? prev_last : -1;
    const bool cap_mask = frizbee::is_upper(first) && frizbee::is_lower(pb) && !is_first;
    const bool delim_mask = delim_byte(pb) && !delim_byte(first) && !is_first;
    const int bonus = (cap_mask ? 4 : 0) + (delim_mask ? 4 : 0) +
                      (is_first && include_prefix ? 12 : 0);
    int diag_in = 0, up_src = 0, mm_new = 0;
    bool mm_prev = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool exactc = active && hay == orig[k];
      const bool occ = exactc || (active && hay == flip[k]);
      const int diag = occ ? diag_in + 12 + bonus + (exactc ? 4 : 0) : max(diag_in - 6, 0);
      const int up = max(up_src - 1 - (mm_prev ? 4 : 0), 0);
      const int left = h[k] - 1 - (((mm_bits >> k) & 1) ? 4 : 0);  // not clamped
      const int cur = max(max(diag, up), left);
      diag_in = h[k];
      up_src = cur;
      mm_prev = occ;
      h[k] = cur;
      mm_new |= (occ ? 1 : 0) << k;
      if (k == N - 1) {
        const int masked = active ? cur : 0;
        if (masked > best) end_b = boff;
        best = max(best, masked);
      }
    }
    // the needle unit at column j (scal[2 + min(j, 63)]), for j < n only
    if (j < N) neq |= hay != __ldg(scal + 2 + j) ? 1 : 0;
    mm_bits = mm_new;
    boff += blen;
    prev_last = last;
  }
  const int score = max(best, 0);
  const bool exact = include_exact && nuv == N && neq == 0;
  o[0] = 1;
  o[1] = score;
  o[2] = exact ? 1 : 0;
  o[3] = score > 0 ? end_b : wstart;
  o[4] = 0;
}

template <int N, int ADV, bool FSTART, bool TAIL, bool CARRIES>
__device__ __forceinline__ void stage_pf(const Row& row, const int (&orig)[N],
                                         const int (&flip)[N], int (&o)[kPlanes]) {
  int np_ = 0, nb = 0, boff = 0, fstart = 0, ffound = 0, e_u = 0, e_found = 0;
  for (int j = 0; j < row.W; ++j) {
    const int hay = row.unit(j);
    const bool valid = row.nu > j;
    const int blen = valid ? 1 : 0;
    bool adv = false, hit0 = false, occ_last = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool occ_k = valid && (hay == orig[k] || hay == flip[k]);
      if (ADV == kChain) adv = adv || (np_ == k && occ_k);
      if (ADV == kAny) adv = adv || occ_k;
      if (k == 0) hit0 = occ_k;
      if (k == N - 1) occ_last = occ_k;
    }
    if (ADV == kHit0) adv = hit0;
    if (FSTART) {
      if (ffound == 0 && hit0) fstart = boff;
      ffound |= hit0 ? 1 : 0;
    }
    const int np2 = np_ + (adv ? 1 : 0);
    if (TAIL) {
      const bool tail = occ_last && np2 >= N;
      if (tail) e_u = boff + blen;
      e_found |= tail ? 1 : 0;
    }
    np_ = np2;
    nb += blen;
    boff += blen;
  }
  o[0] = np_ >= N ? 1 : 0;
  o[1] = nb;
  o[2] = CARRIES ? fstart : 0;
  o[3] = CARRIES ? e_u : 0;
  o[4] = CARRIES ? e_found : 0;
}

template <int STAGE, int N>
__global__ void __launch_bounds__(kThreads) probe_colstream_bisect_kernel(
    const int* __restrict__ cpT, const int* __restrict__ nu, const int* __restrict__ scal,
    int* __restrict__ out, int nG, int W) {
  const long long rows = (long long)nG * kGroupRows;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const long long g = r / kGroupRows;
  const Row row{cpT + g * W * (long long)kGroupRows + (r - g * kGroupRows), __ldg(nu + r), W};
  int orig[N], flip[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    orig[k] = __ldg(scal + 2 + k);
    flip[k] = __ldg(scal + 2 + kMaxNeedle + k);
  }
  int o[kPlanes];
  if constexpr (STAGE == kA) {
    stage_a<N>(row, orig, o);
  } else if constexpr (STAGE == kB) {
    stage_b<N>(row, scal, orig, flip, o);
  } else if constexpr (STAGE == kC) {
    stage_pf<N, kChain, true, true, true>(row, orig, flip, o);
  } else if constexpr (STAGE == kC1) {
    stage_pf<N, kAny, true, true, true>(row, orig, flip, o);
  } else if constexpr (STAGE == kC2) {
    stage_pf<N, kChain, false, false, false>(row, orig, flip, o);
  } else if constexpr (STAGE == kFstartOutz) {
    stage_pf<N, kHit0, true, false, false>(row, orig, flip, o);
  } else if constexpr (STAGE == kTailOutz) {
    stage_pf<N, kHit0, false, true, false>(row, orig, flip, o);
  } else if constexpr (STAGE == kBothOutz) {
    stage_pf<N, kHit0, true, true, false>(row, orig, flip, o);
  } else if constexpr (STAGE == kNoneOutcarries) {
    stage_pf<N, kHit0, false, false, true>(row, orig, flip, o);
  } else {
    stage_pf<N, kHit0, true, true, true>(row, orig, flip, o);
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) out[p * rows + r] = o[p];
}

struct Args {
  const int* cpT;
  const int* nu;
  const int* scal;
  int* out;
  int nG, W;
  cudaStream_t st;
};

template <int STAGE, int N>
void launch(const Args& a) {
  const long long rows = (long long)a.nG * kGroupRows;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  probe_colstream_bisect_kernel<STAGE, N>
      <<<blocks, kThreads, 0, a.st>>>(a.cpT, a.nu, a.scal, a.out, a.nG, a.W);
}

template <int N>
void launch_stage(int stage, const Args& a) {
  switch (stage) {
    case kA: launch<kA, N>(a); break;
    case kB: launch<kB, N>(a); break;
    case kC: launch<kC, N>(a); break;
    case kC1: launch<kC1, N>(a); break;
    case kC2: launch<kC2, N>(a); break;
    case kFstartOutz: launch<kFstartOutz, N>(a); break;
    case kTailOutz: launch<kTailOutz, N>(a); break;
    case kBothOutz: launch<kBothOutz, N>(a); break;
    case kNoneOutcarries: launch<kNoneOutcarries, N>(a); break;
    default: launch<kBothOutcarries, N>(a); break;
  }
}

}  // namespace v1

// the ring design's geometry (probes/colstream_bisect.py ring_geometry
// mirrors it)
constexpr int kThreads = 256;
constexpr int kTileRows = 2 * kThreads;  // two rows a thread
constexpr int kRingStages = 3;
// chunks of 8 columns and 3 blocks an SM for stages A and B (their
// shared memory holds 3), of 16 columns and 2 blocks for the prefilter
// stages, whose light work a column made the longer chunks measure
// faster (PERF.md)
constexpr int kChunkCols = 8;
constexpr int kMinBlocks = 3;
constexpr int kPrefilterChunkCols = 16;
constexpr int kPrefilterMinBlocks = 2;
constexpr int kTilesPerGroup = kGroupRows / kTileRows;

constexpr bool dp_stage(int stage) { return stage == kA || stage == kB; }
template <int STAGE>
using RingOf = frizbee::ColumnRing<kTileRows, dp_stage(STAGE) ? kChunkCols : kPrefilterChunkCols,
                                   kRingStages>;
using frizbee::kNoUnit;
using frizbee::kTableUnits;

// the tables' bytes (column_ring.cuh): A's diagonal operand + 6 (+12 on a
// hit of orig, -6 else), B's + 6 (12 + 4 cls on a hit of either case, 4
// more on an exact one, -6 else) and its gap cost + 5 (-5 after a hit, -1
// after a miss)
constexpr uint32_t kAHit = 18, kMiss = 0;
constexpr uint32_t kGapHit = 0, kGapMiss = 4;
constexpr uint32_t kFive = 0x00050005u, kSix = 0x00060006u, kOne = 0x00010001u;
constexpr int kBonusClasses = 4;
// byte classes of a unit (stage B): the reference's is_upper, is_lower and
// delim of it; kBeforeFirst stands before column 0
constexpr int kUpperBit = 1, kLowerBit = 2, kDelimBit = 4, kBeforeFirst = 8;
constexpr int kClassBytes = 272;      // kTableUnits byte classes, padded to 16
constexpr int kClassPairBytes = 80;   // (kBeforeFirst + 1) x 8, padded

// dynamic shared memory after the ring: the stage's tables
template <int STAGE, int N>
constexpr int table_bytes() {
  constexpr int words = kTableUnits * frizbee::HitWords<N>::kWords * 4;
  return STAGE == kA   ? words
         : STAGE == kB ? (kBonusClasses + 1) * words + kClassBytes + kClassPairBytes
                       : kTableUnits * 4;
}

template <int STAGE, int N>
constexpr int smem_bytes() {
  return RingOf<STAGE>::kBytes + table_bytes<STAGE, N>();
}

// What a block shares: its tables and the needle.
struct Tables {
  const uint32_t* words;    // A: hit words; B: the classes' hit words; else hit bits
  const uint32_t* gaps;     // B: gap-cost words
  const uint8_t* classes;   // B: byte classes of each table unit
  const uint8_t* pairs;     // B: bonus class of (predecessor's, unit's) byte classes
  const int* orig;          // the needle, orig and flip halves
  const int* flip;
};

// the byte classes of unit value u (kTableUnits: none)
__device__ __forceinline__ int byte_classes(int u) {
  return u >= kNoUnit ? 0
                      : (frizbee::is_upper(u) ? kUpperBit : 0) |
                            (frizbee::is_lower(u) ? kLowerBit : 0) |
                            (delim_byte(u) ? kDelimBit : 0);
}

// the bonus class (bonus / 4) of a unit of byte classes c after one of pc
__device__ __forceinline__ int bonus_class(int pc, int c) {
  if (pc == kBeforeFirst) return 3;
  return ((c & kUpperBit) && (pc & kLowerBit) ? 1 : 0) +
         ((pc & kDelimBit) && !(c & kDelimBit) ? 1 : 0);
}

// stage B's diagonal byte of needle unit k for unit u in bonus class cls,
// and its gap-cost byte
__device__ __forceinline__ uint32_t b_hit_byte(int u, int o, int f, int cls) {
  return u == o ? 22u + 4 * cls : (u == f ? 18u + 4 * cls : kMiss);
}
__device__ __forceinline__ uint32_t b_gap_byte(int u, int o, int f) {
  return u == o || u == f ? kGapHit : kGapMiss;
}

// Writes the stage's tables (every thread of the block takes part; the
// first chunk's barrier publishes them).
template <int STAGE, int N>
__device__ __forceinline__ void build_tables(unsigned char* t, const int* scal) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  uint32_t* words = reinterpret_cast<uint32_t*>(t);
  const int* orig = scal + 2;
  const int* flip = scal + 2 + kMaxNeedle;
  if constexpr (STAGE == kA) {
    for (int e = threadIdx.x; e < kTableUnits * NW; e += kThreads) {
      const int u = e / NW, w = e - u * NW;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * w + i;
        const bool hit = k < N && u < kNoUnit && u == __ldg(orig + k);
        word |= (hit ? kAHit : kMiss) << (8 * i);
      }
      words[e] = word;
    }
  } else if constexpr (STAGE == kB) {
    // the classes' diagonal words, then the gap words
    for (int e = threadIdx.x; e < (kBonusClasses + 1) * kTableUnits * NW; e += kThreads) {
      const int entry = e / NW, w = e - entry * NW;
      const int cls = entry / kTableUnits, u = entry - cls * kTableUnits;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * w + i;
        const bool live = k < N && u < kNoUnit;
        const int o = live ? __ldg(orig + k) : -1, f = live ? __ldg(flip + k) : -1;
        const uint32_t byte = cls < kBonusClasses
                                  ? (live ? b_hit_byte(u, o, f, cls) : kMiss)
                                  : (live ? b_gap_byte(u, o, f) : kGapMiss);
        word |= byte << (8 * i);
      }
      words[e] = word;
    }
    uint8_t* classes = t + (kBonusClasses + 1) * kTableUnits * NW * 4;
    uint8_t* pairs = classes + kClassBytes;
    for (int u = threadIdx.x; u < kTableUnits; u += kThreads) classes[u] = byte_classes(u);
    for (int e = threadIdx.x; e < (kBeforeFirst + 1) * 8; e += kThreads)
      pairs[e] = bonus_class(e >> 3, e & 7);
  } else {
    for (int u = threadIdx.x; u < kTableUnits; u += kThreads) {
      uint32_t bits = 0;
      if (u < kNoUnit) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          bits |= (u == __ldg(orig + k) || u == __ldg(flip + k)) ? 1u << k : 0u;
      }
      words[u] = bits;
    }
  }
}

// A row's unit u at column j: its table index (kNoUnit past the row), and
// (BIG: some needle unit lies outside the table) whether its entry must be
// computed, a unit outside the table on the row
template <bool BIG>
struct Unit {
  int idx;
  bool valid, slow;
  __device__ __forceinline__ Unit(int u, int nu, int j)
      : idx(j < nu ? frizbee::table_index(u) : kNoUnit), valid(j < nu),
        slow(BIG && j < nu && frizbee::outside_table(u)) {}
};

// stage A, a row's words
template <int N, int NW, bool BIG>
__device__ __forceinline__ void a_words(int u, int nu, int j, const Tables& tb,
                                        uint32_t (&w)[NW]) {
  const Unit<BIG> x(u, nu, j);
  if (x.slow) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = kMiss * 0x01010101u;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (u == tb.orig[k]) w[k >> 2] |= kAHit << (8 * (k & 3));
  } else {
    frizbee::load_words<NW>(tb.words + x.idx * NW, w);
  }
}

// Stage A: cells as the transposed probe's, + kBias in each half: cur =
// max(diag_in + d - 6, h[k] - 1, 0); best of the last unit's cell.
template <int N, bool BIG, class Ring>
__device__ __forceinline__ void stage_a(const Ring& ring, const Tables& tb, int nu_lo,
                                        int nu_hi, int (&lo)[kPlanes], int (&hi)[kPlanes]) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  uint32_t h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) h[k] = frizbee::kBias;
  uint32_t best = frizbee::kBias;
  ring.template walk<!BIG>([&](const int* col, int j) {
    const int2 u = *reinterpret_cast<const int2*>(col + 2 * threadIdx.x);
    uint32_t wl[NW], wh[NW];
    a_words<N, NW, BIG>(u.x, nu_lo, j, tb, wl);
    a_words<N, NW, BIG>(u.y, nu_hi, j, tb, wh);
    uint32_t diag_in = frizbee::kBias;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t d = frizbee::hit_pair<NW>(k, wl, wh);
      const uint32_t cur = __vimax3_u16x2(diag_in + d - kSix, h[k] - kOne, frizbee::kBias);
      diag_in = h[k];
      h[k] = cur;
    }
    best = __vimax3_u16x2(best, h[N - 1], h[N - 1]);
  });
  best -= frizbee::kBias;
  const int bl = frizbee::half_lo(best), bh = frizbee::half_hi(best);
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) lo[i] = bl + i, hi[i] = bh + i;
}

// stage B's per-row state outside the packed cells
template <bool BIG>
struct BRow {
  int nu, best = 0, end = 0, neq = 0, pc = kBeforeFirst;
  __device__ __forceinline__ explicit BRow(int nu_) : nu(nu_) {}

  // the row's diagonal and gap words at column j; the exact test of the
  // first n columns. Returns whether column j is on the row.
  template <int N, int NW>
  __device__ __forceinline__ bool words(int u, int j, const Tables& tb, uint32_t (&d)[NW],
                                        uint32_t (&g)[NW]) {
    const Unit<BIG> x(u, nu, j);
    const int c = tb.classes[frizbee::table_index(u)];
    const int cls = tb.pairs[pc * 8 + c];
    pc = c;
    if (x.slow) {
#pragma unroll
      for (int i = 0; i < NW; ++i) d[i] = kMiss * 0x01010101u, g[i] = kGapMiss * 0x01010101u;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int s = 8 * (k & 3), o = tb.orig[k], f = tb.flip[k];
        d[k >> 2] = (d[k >> 2] & ~(0xFFu << s)) | (b_hit_byte(u, o, f, cls) << s);
        g[k >> 2] = (g[k >> 2] & ~(0xFFu << s)) | (b_gap_byte(u, o, f) << s);
      }
    } else {
      frizbee::load_words<NW>(tb.words + (cls * kTableUnits + x.idx) * NW, d);
      frizbee::load_words<NW>(tb.gaps + x.idx * NW, g);
    }
    if (j < N) neq |= u != tb.orig[j] ? 1 : 0;
    return x.valid;
  }

  // the last needle unit's cell v (unbiased) at column j
  __device__ __forceinline__ void last(bool valid, int v, int j) {
    if (valid && v > best) best = v, end = j;
  }

  template <int N>
  __device__ __forceinline__ void planes(int (&o)[kPlanes]) const {
    o[0] = 1;
    o[1] = best;  // >= 0 already: max(best, 0)
    o[2] = nu == N && neq == 0 ? 1 : 0;
    o[3] = best > 0 ? end : 0;
    o[4] = 0;
  }
};

// Stage B: in each half, + kBias,
//   t   = max(diag_in + d - 6, h[k] + l_k - 5, 0)
//   cur = max(up_src + g_{k-1} - 5, t)
// (d, g, l from the tables: the operand + 6 and the gap cost + 5; l_k the
// previous column's g_k), the up move's serial chain an add and a max.
template <int N, bool BIG, class Ring>
__device__ __forceinline__ void stage_b(const Ring& ring, const Tables& tb, int nu_lo,
                                        int nu_hi, int (&lo)[kPlanes], int (&hi)[kPlanes]) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  uint32_t h[N], l[N];
#pragma unroll
  for (int k = 0; k < N; ++k) h[k] = frizbee::kBias, l[k] = kGapMiss * 0x00010001u;
  BRow<BIG> rl(nu_lo), rh(nu_hi);
  ring.template walk<!BIG>([&](const int* col, int j) {
    const int2 u = *reinterpret_cast<const int2*>(col + 2 * threadIdx.x);
    uint32_t dl[NW], gl[NW], dh[NW], gh[NW];
    const bool vl = rl.template words<N, NW>(u.x, j, tb, dl, gl);
    const bool vh = rh.template words<N, NW>(u.y, j, tb, dh, gh);
    uint32_t diag_in = frizbee::kBias, up_src = 0, g_up = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t d = frizbee::hit_pair<NW>(k, dl, dh);
      const uint32_t g = frizbee::hit_pair<NW>(k, gl, gh);
      uint32_t cur = __vimax3_u16x2(diag_in + d - kSix, h[k] + l[k] - kFive, frizbee::kBias);
      if (k > 0) cur = __vimax3_u16x2(up_src + g_up - kFive, cur, cur);
      diag_in = h[k];
      h[k] = cur;
      l[k] = g;
      up_src = cur;
      g_up = g;
    }
    const uint32_t v = h[N - 1] - frizbee::kBias;
    rl.last(vl, frizbee::half_lo(v), j);
    rh.last(vh, frizbee::half_hi(v), j);
  });
  rl.template planes<N>(lo);
  rh.template planes<N>(hi);
}

// a prefilter stage's per-row state: np, the first hit's column (fmin,
// INT_MAX while none) and the last tail's end (0 while none)
template <int N, int ADV, bool FSTART, bool TAIL, bool CARRIES, bool BIG>
struct PfRow {
  int nu, np = 0, fmin = 0x7FFFFFFF, e_u = 0;
  __device__ __forceinline__ explicit PfRow(int nu_) : nu(nu_) {}

  __device__ __forceinline__ void step(int u, int j, const Tables& tb) {
    const Unit<BIG> x(u, nu, j);
    uint32_t b;
    if (x.slow) {
      b = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) b |= (u == tb.orig[k] || u == tb.flip[k]) ? 1u << k : 0u;
    } else {
      b = tb.words[x.idx];
    }
    if constexpr (ADV == kChain) {
      np += (b >> np) & 1;  // np <= N: the chain stops there
    } else if constexpr (ADV == kAny) {
      np += b != 0 ? 1 : 0;
    } else {
      np += b & 1;
    }
    if constexpr (FSTART) fmin = min(fmin, (b & 1) ? j : 0x7FFFFFFF);
    if constexpr (TAIL) {
      if (((b >> (N - 1)) & 1) && np >= N) e_u = j + 1;
    }
  }

  __device__ __forceinline__ void planes(int W, int (&o)[kPlanes]) const {
    o[0] = np >= N ? 1 : 0;
    o[1] = min(max(nu, 0), W);  // the columns on the row
    o[2] = CARRIES && FSTART && fmin != 0x7FFFFFFF ? fmin : 0;
    o[3] = CARRIES ? e_u : 0;
    o[4] = CARRIES && e_u > 0 ? 1 : 0;
  }
};

template <int N, int ADV, bool FSTART, bool TAIL, bool CARRIES, bool BIG,
          class Ring>
__device__ __forceinline__ void stage_pf(const Ring& ring, const Tables& tb, int nu_lo,
                                         int nu_hi, int (&lo)[kPlanes], int (&hi)[kPlanes]) {
  PfRow<N, ADV, FSTART, TAIL, CARRIES, BIG> rl(nu_lo), rh(nu_hi);
  ring.template walk<!BIG>([&](const int* col, int j) {
    const int2 u = *reinterpret_cast<const int2*>(col + 2 * threadIdx.x);
    rl.step(u.x, j, tb);
    rh.step(u.y, j, tb);
  });
  rl.planes(ring.W, lo);
  rh.planes(ring.W, hi);
}

template <int STAGE, int N, bool BIG, class Ring>
__device__ __forceinline__ void stage(const Ring& ring, const Tables& tb, int nu_lo, int nu_hi,
                                      int (&lo)[kPlanes], int (&hi)[kPlanes]) {
  if constexpr (STAGE == kA) {
    stage_a<N, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kB) {
    stage_b<N, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kC) {
    stage_pf<N, kChain, true, true, true, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kC1) {
    stage_pf<N, kAny, true, true, true, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kC2) {
    stage_pf<N, kChain, false, false, false, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kFstartOutz) {
    stage_pf<N, kHit0, true, false, false, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kTailOutz) {
    stage_pf<N, kHit0, false, true, false, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kBothOutz) {
    stage_pf<N, kHit0, true, true, false, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else if constexpr (STAGE == kNoneOutcarries) {
    stage_pf<N, kHit0, false, false, true, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else {
    stage_pf<N, kHit0, true, true, true, BIG>(ring, tb, nu_lo, nu_hi, lo, hi);
  }
}

template <int STAGE, int N>
__global__ void __launch_bounds__(kThreads, dp_stage(STAGE) ? kMinBlocks : kPrefilterMinBlocks)
    probe_colstream_bisect_ring_kernel(
    const int* __restrict__ cpT, const int* __restrict__ nu, const int* __restrict__ scal,
    int* __restrict__ out, int nG, int W) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_orig[N], s_flip[N];
  const int g = blockIdx.x / kTilesPerGroup;
  const int r0 = (blockIdx.x - g * kTilesPerGroup) * kTileRows;
  using Ring = RingOf<STAGE>;
  const Ring ring(reinterpret_cast<int*>(smem),
                  cpT + (long long)g * W * kGroupRows + r0, kGroupRows, W);
  ring.start();
  unsigned char* t = smem + Ring::kBytes;
  build_tables<STAGE, N>(t, scal);
  bool big = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    big |= frizbee::outside_table(__ldg(scal + 2 + k));
    if (STAGE != kA) big |= frizbee::outside_table(__ldg(scal + 2 + kMaxNeedle + k));
  }
  if (threadIdx.x < N) {
    s_orig[threadIdx.x] = __ldg(scal + 2 + threadIdx.x);
    s_flip[threadIdx.x] = __ldg(scal + 2 + kMaxNeedle + threadIdx.x);
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(t);
  const uint8_t* classes = t + (kBonusClasses + 1) * kTableUnits * NW * 4;
  const Tables tb{words, words + kBonusClasses * kTableUnits * NW, classes,
                  classes + kClassBytes, s_orig, s_flip};
  const long long rows = (long long)nG * kGroupRows;
  const long long r = (long long)g * kGroupRows + r0 + 2 * threadIdx.x;
  const int nu_lo = __ldg(nu + r), nu_hi = __ldg(nu + r + 1);
  int lo[kPlanes], hi[kPlanes];
  if (big) {
    stage<STAGE, N, true>(ring, tb, nu_lo, nu_hi, lo, hi);
  } else {
    stage<STAGE, N, false>(ring, tb, nu_lo, nu_hi, lo, hi);
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    *reinterpret_cast<int2*>(out + p * rows + r) = make_int2(lo[p], hi[p]);
}

struct Args {
  const int* cpT;
  const int* nu;
  const int* scal;
  int* out;
  int nG, W;
  cudaStream_t st;
};

template <int STAGE, int N>
int launch(const Args& a) {
  auto kernel = probe_colstream_bisect_ring_kernel<STAGE, N>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<STAGE, N>());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)a.nG * kTilesPerGroup, kThreads, smem_bytes<STAGE, N>(), a.st>>>(
      a.cpT, a.nu, a.scal, a.out, a.nG, a.W);
  return (int)cudaGetLastError();
}

template <int N>
int launch_stage(int stage, const Args& a) {
  switch (stage) {
    case kA: return launch<kA, N>(a);
    case kB: return launch<kB, N>(a);
    case kC: return launch<kC, N>(a);
    case kC1: return launch<kC1, N>(a);
    case kC2: return launch<kC2, N>(a);
    case kFstartOutz: return launch<kFstartOutz, N>(a);
    case kTailOutz: return launch<kTailOutz, N>(a);
    case kBothOutz: return launch<kBothOutz, N>(a);
    case kNoneOutcarries: return launch<kNoneOutcarries, N>(a);
    default: return launch<kBothOutcarries, N>(a);
  }
}

}  // namespace

// C entry point (bound with ctypes). cpT (nG * W, 8, 128) int32 units,
// 16-byte aligned; nu (nG * 8, 128) int32 unit counts, scal the (130,)
// int32 needle scalars ([count, n, orig x 64, flip x 64]), out (5, nG * 8,
// 128) int32 planes; stage in [0, 10) (STAGES order), 1 <= n <= 16.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments it refuses).
extern "C" int probe_colstream_bisect_launch(const void* cpT, const void* nu, const void* scal,
                                             void* out, int nG, int W, int n, int stage,
                                             void* stream) {
  if (nG < 0 || W < 0 || n < 1 || n > 16 || stage < 0 || stage >= kStages ||
      ((uintptr_t)cpT & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (nG == 0) return 0;
  const Args a{static_cast<const int*>(cpT), static_cast<const int*>(nu),
               static_cast<const int*>(scal), static_cast<int*>(out), nG, W,
               static_cast<cudaStream_t>(stream)};
  switch (n) {
#define PROBE_BISECT_CASE(N) \
  case N:                    \
    return launch_stage<N>(stage, a);
    PROBE_BISECT_CASE(1) PROBE_BISECT_CASE(2) PROBE_BISECT_CASE(3) PROBE_BISECT_CASE(4)
    PROBE_BISECT_CASE(5) PROBE_BISECT_CASE(6) PROBE_BISECT_CASE(7) PROBE_BISECT_CASE(8)
    PROBE_BISECT_CASE(9) PROBE_BISECT_CASE(10) PROBE_BISECT_CASE(11) PROBE_BISECT_CASE(12)
    PROBE_BISECT_CASE(13) PROBE_BISECT_CASE(14) PROBE_BISECT_CASE(15) PROBE_BISECT_CASE(16)
#undef PROBE_BISECT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The first design (a row a thread, one 4-byte load in flight), with the
// same arguments and results; only chip_smoke.py's A/B calls it.
extern "C" int probe_colstream_bisect_v1_launch(const void* cpT, const void* nu,
                                                const void* scal, void* out, int nG, int W,
                                                int n, int stage, void* stream) {
  if (nG < 0 || W < 0 || n < 1 || n > 16 || stage < 0 || stage >= kStages)
    return (int)cudaErrorInvalidValue;
  if (nG == 0) return 0;
  const v1::Args a{static_cast<const int*>(cpT), static_cast<const int*>(nu),
                   static_cast<const int*>(scal), static_cast<int*>(out), nG, W,
                   static_cast<cudaStream_t>(stream)};
  switch (n) {
#define PROBE_BISECT_CASE(N) \
  case N:                    \
    v1::launch_stage<N>(stage, a); \
    break;
    PROBE_BISECT_CASE(1) PROBE_BISECT_CASE(2) PROBE_BISECT_CASE(3) PROBE_BISECT_CASE(4)
    PROBE_BISECT_CASE(5) PROBE_BISECT_CASE(6) PROBE_BISECT_CASE(7) PROBE_BISECT_CASE(8)
    PROBE_BISECT_CASE(9) PROBE_BISECT_CASE(10) PROBE_BISECT_CASE(11) PROBE_BISECT_CASE(12)
    PROBE_BISECT_CASE(13) PROBE_BISECT_CASE(14) PROBE_BISECT_CASE(15) PROBE_BISECT_CASE(16)
#undef PROBE_BISECT_CASE
  }
  return (int)cudaGetLastError();
}
