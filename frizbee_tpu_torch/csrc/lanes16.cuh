// s16x2 lanes: two int16 DP rows in the halves of one 32-bit register,
// the Hopper form of the int16 lanes of frizbee_tpu's kernels
// (match_units and match_units_colstream with int16_lanes=True). The low
// half holds one row, the high half the other. Header only; the int16
// instantiations of match_units.cu and colstream_fuzzy.cu use it, and
// lane_contract.cu holds every helper here, and each DPX operation the
// kernels apply to packed words, against a plain model.
//
// Bounds. The wrappers admit a scoring only where
// ops/kernels.score_fits_int16 holds: every cell, n * (match + case +
// max(cap, delim)) + prefix, stays below 30000, and so do the gap costs
// (W * (gap_extend + gap_open') < 30000) and, clamped to 30000, the
// mismatch cost. A cell is max(diag + d, up + gu, left + gl, 0): diag, up
// and left are earlier cells in [0, 30000); d is a hit, and diag + d then
// a cell value below 30000, or -mismatch; gu and gl are negated gap costs.
// So every sum lies in (-30000, 30000) and no s16x2 add wraps. At W =
// 1024, n = 64 the default scoring's largest cell is 64 * 20 + 12 = 1292
// (score_fits_int16 adds 8 for the exact bonus, applied after the DP in
// 32 bits, and 5120 for the reference's gap scan, which the CUDA cell
// does not run).

#pragma once

#include "kernel_common.cuh"

namespace frizbee {

// the cell and cost ceiling of the int16 lanes (ops/kernels.py
// INT16_SCORE_LIMIT)
constexpr int kInt16ScoreLimit = 30000;

// (lo, hi) int16 values packed into one word
__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (uint32_t)(lo & 0xFFFF) | ((uint32_t)hi << 16);
}
__device__ __forceinline__ int lo16(uint32_t x) { return (int)(int16_t)(x & 0xFFFFu); }
__device__ __forceinline__ int hi16(uint32_t x) { return (int)(int16_t)(x >> 16); }

// PTX prmt.b32 in its default mode: result byte i is byte (sel nibble i
// & 7) of the pair (a, b), or, where the nibble's bit 3 is set, that
// byte's sign bit replicated over all eight bits
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// 0xFFFF in the low half where bit k of ``lo`` is set, in the high half
// where bit k of ``hi`` is: each bit shifted to its word's sign bit and
// replicated over a half by one prmt
__device__ __forceinline__ uint32_t half_masks(uint32_t lo, uint32_t hi, int k) {
  return prmt(lo << (31 - k), hi << (31 - k), 0xFFBBu);
}

// the same of one word that holds the low row's 16 bits in bits 0-15 and
// the high row's in bits 16-31 (pair16)
__device__ __forceinline__ uint32_t half_masks16(uint32_t w, int k) {
  return prmt(w << (15 - k), 0u, 0xBB99u);
}

// the low 16 bits of ``lo`` and of ``hi`` in one word
__device__ __forceinline__ uint32_t pair16(uint32_t lo, uint32_t hi) {
  return prmt(lo, hi, 0x5410u);
}

// the high 16 bits of ``lo`` and of ``hi`` in one word
__device__ __forceinline__ uint32_t pair16_high(uint32_t lo, uint32_t hi) {
  return prmt(lo, hi, 0x7632u);
}

// per-half select: a's bits where m is set, else b's (one LOP3)
__device__ __forceinline__ uint32_t sel2(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// The per-unit bits of two rows (the needle units a value matches) for
// needles of up to NMAX units, interleaved when the pair's two table
// lookups are merged: word c holds units 16c..16c+15 of the low row in
// bits 0-15 and of the high row in bits 16-31 (pair16, pair16_high), so a
// unit's pair of half masks is one shift and one prmt (half_masks16) at
// every NMAX; the unit loop is unrolled, so the word is picked at compile
// time.
template <int NMAX>
struct PairBits {
  static constexpr int kWords = NMAX / 16;
  uint32_t w[kWords];
  __device__ __forceinline__ PairBits() {
#pragma unroll
    for (int c = 0; c < kWords; ++c) w[c] = 0;
  }
  // lo, hi: the two rows' unit masks (32-bit words for NMAX <= 32, else
  // 64-bit)
  template <typename Mask>
  __device__ __forceinline__ PairBits(Mask lo, Mask hi) {
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      uint32_t l = (uint32_t)lo, h = (uint32_t)hi;
      if constexpr (sizeof(Mask) == 8) {
        if (c >= 2) {
          l = (uint32_t)((unsigned long long)lo >> 32);
          h = (uint32_t)((unsigned long long)hi >> 32);
        }
      }
      w[c] = (c & 1) ? pair16_high(l, h) : pair16(l, h);
    }
  }
  __device__ __forceinline__ uint32_t mask(int k) const {
    return half_masks16(w[k >> 4], k & 15);
  }
};

// The pass-2 queue of the int16-lane kernels: the rows (or row and query
// entries) that run pass 2, ordered by trimmed-window length, so the two
// halves of a pair walk about as many columns. A counting sort into
// kQueueBins bins of the length over [0, W], longest first: a thread
// takes its bin's next place with a shared atomic (its order inside the
// bin is free, and no output depends on it: the halves of a pair are
// independent), and after a barrier each warp scans the bins' counts,
// a bin a lane (QueueScan), so a place is its bin's first place, read by
// a shuffle, plus the place the atomic gave.
constexpr int kQueueBins = 32;
static_assert(kQueueBins == 32, "a bin a lane of the scan");

// the bin of a window of ``len`` columns of a W-column row, longest first
__device__ __forceinline__ int queue_bin(int len, int W) {
  return kQueueBins - 1 - min(len * kQueueBins / (W + 1), kQueueBins - 1);
}

// The bins' first queue places and the queue's length, from the counts
// in ``bins``; every lane of the warp takes part.
struct QueueScan {
  int first;  // this lane's bin's first place
  int total;  // the queue's length
  __device__ __forceinline__ explicit QueueScan(const int* bins) {
    const int lane = threadIdx.x & 31, c = bins[lane];
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    first = x - c;
    total = __shfl_sync(0xFFFFFFFFu, x, 31);
  }
  // the first place of bin b (every lane calls it)
  __device__ __forceinline__ int base(int b) const {
    return __shfl_sync(0xFFFFFFFFu, first, b);
  }
};

// The DP cell of needle unit k > 0 for both rows: max(diag + d, up + gu,
// left + gl, 0) (gu, gl the negated gap costs), three DPX add-max. A
// sum never wraps under the bounds above.
__device__ __forceinline__ uint32_t cell2(uint32_t diag, uint32_t d, uint32_t up,
                                          uint32_t gu, uint32_t left, uint32_t gl) {
  const uint32_t t = __viaddmax_s16x2_relu(left, gl, 0u);
  return __viaddmax_s16x2(diag, d, __viaddmax_s16x2(up, gu, t));
}

// The running best of both rows after a cell x: max(best, x) per half
// (one DPX add-max), and in *raised which halves x raised (bit 0 the low
// half, bit 1 the high half), read off the halves that changed.
__device__ __forceinline__ uint32_t best2(uint32_t best, uint32_t x, int* raised) {
  const uint32_t nb = __viaddmax_s16x2(x, 0u, best);
  const uint32_t changed = nb ^ best;
  *raised = ((changed & 0xFFFFu) ? 1 : 0) | ((changed >> 16) ? 2 : 0);
  return nb;
}

// The per-half match score of needle unit k: the case hit where the unit
// equals the needle's original (me), the base hit where it matches in
// either case (mo), else -mismatch; each operand packed.
__device__ __forceinline__ uint32_t hit2(uint32_t mo, uint32_t me, uint32_t case_hit,
                                         uint32_t base_hit, uint32_t neg_mismatch) {
  return sel2(mo, sel2(me, case_hit, base_hit), neg_mismatch);
}

}  // namespace frizbee
