// A block's column ring: the unit columns of a tile of rows streamed
// through shared memory a chunk of columns at a time, several chunks in
// flight, for the probe kernels (probe_transposed.cu,
// probe_colstream_bisect.cu). Header only; each .cu that includes it builds
// on its own. The served column-stream kernels stage a whole tile at once
// (colstream_tile.cuh) and do not use it.
//
// Layout: a tile is ROWS consecutive rows of one layout block, and column
// j of the tile is one run of ROWS contiguous int32 units at src + j *
// stride. Shared memory holds STAGES slots of COLS columns, each column
// ROWS units, column-major ([j * ROWS + r]), so a thread reads its rows of
// a column with one 8-byte load and a warp reads 256 contiguous bytes.
//
// Copies are TMA bulk copies (cp.async.bulk): one thread issues a copy of
// each column's ROWS * 4 contiguous bytes, and they complete on the
// slot's mbarrier, whose expected bytes that thread sets first. Pipeline
// (walk): start() sets up the STAGES mbarriers and issues chunks 0 ..
// STAGES-2; acquire(c) waits on chunk c's mbarrier (phase c / STAGES),
// meets the block at a barrier (every thread done with chunk c-1), then
// issues chunk c + STAGES - 1 into the slot chunk c-1 used. So while the
// block walks chunk c, chunks c+1 .. c+STAGES-1 are in flight: the bytes
// in flight do not depend on how many rows the launch has. The bulk
// copies measured faster than per-thread 16-byte cp.async copies of the
// same ring on both probe kernels (PERF.md). src must be 16-byte aligned
// and ROWS a multiple of 4.

#pragma once

#include <stdint.h>

namespace frizbee {

template <int ROWS, int COLS, int STAGES>
struct ColumnRing {
  static_assert(ROWS % 4 == 0, "a column is a whole number of 16-byte units");
  static_assert(STAGES >= 3, "at least two chunks in flight");
  static constexpr int kSlotInts = ROWS * COLS;
  static constexpr int kBytes = STAGES * kSlotInts * 4;

  int* buf;           // STAGES slots of COLS columns x ROWS units
  const int* src;     // the tile's first row in column 0
  long long stride;   // units from one column of the layout to the next
  int W;              // columns of the tile
  int chunks;         // ceil(W / COLS)

  __device__ __forceinline__ ColumnRing(int* buf_, const int* src_, long long stride_,
                                        int W_)
      : buf(buf_), src(src_), stride(stride_), W(W_), chunks((W_ + COLS - 1) / COLS) {}

  // the columns of chunk c (COLS, fewer in a last partial chunk)
  __device__ __forceinline__ int columns(int c) const { return min(COLS, W - c * COLS); }

  // the slots' mbarriers
  static __device__ __forceinline__ uint64_t* bars() {
    __shared__ uint64_t b[STAGES];
    return b;
  }

  // Issues chunk c's bulk copies into slot c % STAGES (none past the last
  // chunk): one thread, a copy a column, completing on the slot's mbarrier.
  __device__ __forceinline__ void issue(int c) const {
    if (threadIdx.x == 0 && c < chunks) {
      const int j0 = c * COLS, ncols = columns(c);
      const unsigned bar = (unsigned)__cvta_generic_to_shared(bars() + c % STAGES);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"((unsigned)(ncols * ROWS * 4))
                   : "memory");
      int* dst = buf + (c % STAGES) * kSlotInts;
      for (int j = 0; j < ncols; ++j) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + j * ROWS);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(d),
            "l"(src + (long long)(j0 + j) * stride), "r"((unsigned)(ROWS * 4)), "r"(bar)
            : "memory");
      }
    }
  }

  __device__ __forceinline__ void start() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        const unsigned bar = (unsigned)__cvta_generic_to_shared(bars() + s);
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
  }

  // Chunk c's slot, complete and visible to the block; chunk c + STAGES
  // - 1 is in flight on return.
  __device__ __forceinline__ const int* acquire(int c) const {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(bars() + c % STAGES);
    const unsigned parity = (unsigned)(c / STAGES) & 1u;
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
    __syncthreads();
    issue(c + STAGES - 1);
    return buf + (c % STAGES) * kSlotInts;
  }

  // After start(), walks every column of the tile in order: f(column, j)
  // with column the slot's ROWS units of column j. A whole chunk's columns
  // are unrolled where UNROLL. Work between start() and walk() overlaps
  // the first chunks' copies.
  template <bool UNROLL = true, class F>
  __device__ __forceinline__ void walk(F&& f) const {
    for (int c = 0; c < chunks; ++c) {
      const int* slot = acquire(c);
      const int j0 = c * COLS, ncols = columns(c);
      if (UNROLL && ncols == COLS) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) f(slot + j * ROWS, j0 + j);
      } else {
#pragma unroll 1
        for (int j = 0; j < ncols; ++j) f(slot + j * ROWS, j0 + j);
      }
    }
  }
};

// The needle-hit table of the probe kernels: for each unit value u in [0,
// 256) and a last entry (index kNoUnit) that matches no needle unit, NW
// words of per-needle-unit bytes, byte k % 4 of word k / 4 for needle unit
// k. A pair's operand of needle unit k is then one prmt of the two rows'
// words, which extends the byte into each 16-bit half (hit_pair). Units
// outside [0, 256) take kNoUnit when no needle unit lies outside that
// range; a kernel whose needle has one ("big") computes their bytes from
// the needle (exact for every int32 unit) on a path of its own.
//
// The cells the probe kernels pack two to a word hold their values plus
// kBias in each unsigned 16-bit half: every value a walk forms then stays
// inside [0, 65536), so a 32-bit add or subtract of packed operands acts
// on each half apart (no carry or borrow crosses), and the adds can issue
// as IADD3 or IMAD, off the pipe that the prmt and the DPX max (VIMNMX3)
// take, which runs 64 lanes an SM a clock (measured: pipe_rates.py).
constexpr uint32_t kBias = 0x00400040u;  // 64 in both halves
constexpr int kNoUnit = 256;
constexpr int kTableUnits = kNoUnit + 1;

template <int N>
struct HitWords {
  static_assert(N >= 1 && N <= 16, "needles of 1-16 units");
  // words an entry: 1, 2 or 4 (one 4-, 8- or 16-byte shared load)
  static constexpr int kWords = N <= 4 ? 1 : (N <= 8 ? 2 : 4);
};

// The table index of unit u: u itself in [0, 256), else kNoUnit.
__device__ __forceinline__ int table_index(int u) {
  return (int)min((unsigned)u, (unsigned)kNoUnit);
}

template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// Needle unit k's operand for both rows of a pair: byte k of the low row's
// words sign-extended into the low half, of the high row's into the high
// half (one prmt; k is a constant of an unrolled loop, so the word and the
// selector are too).
template <int NW>
__device__ __forceinline__ uint32_t hit_pair(int k, const uint32_t (&lo)[NW],
                                             const uint32_t (&hi)[NW]) {
  const unsigned b = k & 3;
  const unsigned sel = b | ((8u | b) << 4) | ((4u + b) << 8) | ((12u + b) << 12);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo[k >> 2]), "r"(hi[k >> 2]), "r"(sel));
  return d;
}

// The two int16 halves of a packed word, sign-extended.
__device__ __forceinline__ int half_lo(uint32_t x) { return (int)(int16_t)(x & 0xFFFFu); }
__device__ __forceinline__ int half_hi(uint32_t x) { return (int)(int16_t)(x >> 16); }

// A needle unit lies outside the table's [0, 256).
__device__ __forceinline__ bool outside_table(int v) { return (unsigned)v >= (unsigned)kNoUnit; }

}  // namespace frizbee
