// The stages of the reference's column-stream bisect probes, for Hopper
// (sm_90a): the colstream fuzzy kernel built up piece by piece, each stage
// writing five int32 planes.
//
// Replaces the Pallas kernels run by benchmarks/probe_colstream_bisect.py
// (run :41, pallas_call :42: stage_a :63, stage_b :88, stage_c :173,
// stage_c1 :236, stage_c2 :272) and benchmarks/probe_colstream_bisect2.py
// (run :35, pallas_call :36: make_stage(track_fstart, track_tail,
// out_carries) :57 over five combinations). There a grid step holds a
// group of 8 x 128 rows in vector registers and walks its W unit columns;
// here a thread is a row. The reference's block (nG * W, 8, 128) int32 is,
// with no copy, (nG, W, 1024): unit j of row i of group g at [g, j, i], so
// the threads of a warp read neighbouring words of each column; the unit
// counts (nG * 8, 128) are (nG, 1024).
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
// Bound on this card: operations (the int32 work a (row, column, needle
// unit) cell and a (row, column) step take, counted in chip_smoke.py),
// against 4 bytes a unit read once, 4 bytes of unit count and 20 bytes of
// planes a row. Every carry lives in registers (n <= 16).

#include "kernel_common.cuh"

namespace {

using frizbee::kMaxNeedle;

constexpr int kGroupRows = 8 * 128;  // rows of one colstream group
constexpr int kPlanes = 5;
constexpr int kThreads = 256;

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

}  // namespace

// C entry point (bound with ctypes). cpT (nG * W, 8, 128) int32 units, nu
// (nG * 8, 128) int32 unit counts, scal the (130,) int32 needle scalars
// ([count, n, orig x 64, flip x 64]), out (5, nG * 8, 128) int32 planes;
// stage in [0, 10) (STAGES order), 1 <= n <= 16. Returns
// cudaGetLastError() after the launch.
extern "C" int probe_colstream_bisect_launch(const void* cpT, const void* nu, const void* scal,
                                             void* out, int nG, int W, int n, int stage,
                                             void* stream) {
  if (nG < 0 || W < 0 || n < 1 || n > 16 || stage < 0 || stage >= kStages)
    return (int)cudaErrorInvalidValue;
  if (nG == 0) return 0;
  const Args a{static_cast<const int*>(cpT), static_cast<const int*>(nu),
               static_cast<const int*>(scal), static_cast<int*>(out), nG, W,
               static_cast<cudaStream_t>(stream)};
  switch (n) {
#define PROBE_BISECT_CASE(N) \
  case N:                    \
    launch_stage<N>(stage, a); \
    break;
    PROBE_BISECT_CASE(1) PROBE_BISECT_CASE(2) PROBE_BISECT_CASE(3) PROBE_BISECT_CASE(4)
    PROBE_BISECT_CASE(5) PROBE_BISECT_CASE(6) PROBE_BISECT_CASE(7) PROBE_BISECT_CASE(8)
    PROBE_BISECT_CASE(9) PROBE_BISECT_CASE(10) PROBE_BISECT_CASE(11) PROBE_BISECT_CASE(12)
    PROBE_BISECT_CASE(13) PROBE_BISECT_CASE(14) PROBE_BISECT_CASE(15) PROBE_BISECT_CASE(16)
#undef PROBE_BISECT_CASE
  }
  return (int)cudaGetLastError();
}
