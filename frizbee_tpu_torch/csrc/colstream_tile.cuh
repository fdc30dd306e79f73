// The corpus tile of the column-stream kernels (colstream_fuzzy.cu,
// colstream_literal.cu): a block stages the unit columns of a tile of rows
// of one 1024-row group in shared memory once, then walks each row from
// there for every query it serves. Header only; each .cu that includes it
// builds on its own.
//
// Layout: row r of group g at unit column j is element (g*W + j)*1024 + r
// of cpT and of the optional int8 ctx plane, so a tile's column j is one
// run of `rows` contiguous units, copied with 16-byte cp.async. Shared
// memory holds the tile column-major as well: the units at [j*rows + r]
// (1 or 4 bytes each), then, on a codepoint tile, a plane of one byte a
// unit at rows*W*4 + [j*rows + r]: the staged ctx bytes, which
// TileRow::prepare turns into class bytes (the unit's bonus after its
// predecessor and its byte length), computed once for all the block's
// queries. A warp's threads read one column at a time.
//
// Geometry (tile_geometry; ops/colstream.tile_geometry mirrors it): a tile
// is 128, 64 or 32 rows, the most whose W columns (of units, and of
// class bytes on codepoint rows) fit kTileBytes, and one warp's 32 rows
// at least, which a w512 or
// w1024 codepoint bucket stages in 80 or 160 KB of dynamic shared memory
// (the launch opts in above 48 KB). A block serves at most
// kBlockColumns / W of the launch's queries, and the queries split into
// more chunks where the launch would have fewer than kTargetBlocks blocks:
// a block that walked every query of a many-group bucket would run far
// longer than the rest (measured on an H100: PERF.md). So a launch
// stages each tile once per chunk of queries (once in all where Q <=
// kBlockColumns / W); a tile's chunks are neighbouring blocks, so their
// reads of the tile meet in L2.

#pragma once

#include "kernel_common.cuh"

namespace frizbee {

constexpr int kGroupRows = 1024;
constexpr int kTileMaxRows = 128;
constexpr int kTileBytes = 48 * 1024;
constexpr int kTargetBlocks = 1024;
// a block serves at most kBlockColumns / W queries (at least one, at
// most kMaxBlockQueries), so no block runs much longer than the rest
constexpr int kBlockColumns = 512;
// the most queries a block serves: their needles are staged at once
constexpr int kMaxBlockQueries = 32;
constexpr int kColstreamNeedle = 16;

struct TileGeometry {
  int rows;    // rows of a tile = threads of a block
  int qper;    // queries a block serves
  int chunks;  // blocks of one tile
  int tiles;   // tiles of the launch
  int smem;    // dynamic shared memory bytes of a block
};

// unit_bytes: shared-memory bytes a unit (1 a byte; 5 a codepoint: the
// unit and its class byte)
inline TileGeometry tile_geometry(int W, int unit_bytes, int n_groups, int Q) {
  int rows = kTileMaxRows;
  while (rows > 32 && rows * W * unit_bytes > kTileBytes) rows /= 2;
  const int tiles = n_groups * (kGroupRows / rows);
  int cap = kBlockColumns / W;
  cap = cap < 1 ? 1 : (cap > kMaxBlockQueries ? kMaxBlockQueries : cap);
  int split = (kTargetBlocks + tiles - 1) / tiles;
  if ((Q + cap - 1) / cap > split) split = (Q + cap - 1) / cap;
  split = split > Q ? Q : split;
  const int qper = (Q + split - 1) / split;
  return TileGeometry{rows, qper, (Q + qper - 1) / qper, tiles,
                      rows * W * unit_bytes};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Issues the 16-byte copies of columns [0, ncols) of one plane of the
// tile (unit_size bytes a unit); src is the plane's first unit of the
// tile's group at row r0.
__device__ __forceinline__ void stage_plane(uint8_t* dst, const uint8_t* src,
                                            int unit_size, int ncols, int rows) {
  const int vpc = rows * unit_size / 16;  // 16-byte copies a column
  const int total = ncols * vpc;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / vpc, v = i - j * vpc;
    cp_async16(dst + j * rows * unit_size + v * 16,
               src + (long long)j * kGroupRows * unit_size + v * 16);
  }
}

// Waits for this thread's copies; a __syncthreads() after it makes the
// whole tile visible.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The block's share of one launch and its tile: which rows, which queries.
struct TileBlock {
  int g, r0, q0, q1, slot;
  __device__ TileBlock(int chunks, int qper, int Q) {
    const int rows = blockDim.x;
    const int tile = blockIdx.x / chunks;
    q0 = (blockIdx.x - tile * chunks) * qper;
    q1 = min(q0 + qper, Q);
    const int per_group = kGroupRows / rows;
    g = tile / per_group;
    r0 = (tile - g * per_group) * rows;
    slot = g * kGroupRows + r0 + threadIdx.x;
  }
  // the group is alive for query q: below its live count, flag set
  __device__ bool alive(int q, const int* scalars, const int* flags,
                        int n_groups) const {
    bool a = (long long)g * kGroupRows < scalars[(long long)q * kScalars];
    if (flags != nullptr) a = a && flags[(long long)q * n_groups + g] > 0;
    return a;
  }
};

// Issues the copies of the tile for a block that some query keeps alive:
// the units (and ctx bytes) of columns [0, ncols), ncols the longest of
// the threads' row lengths ``len`` (min(nu, W)) clamped to col_cap.
// *s_cols must be 0 and visible to the block on entry. Every thread of the
// block calls it; stage_wait() and a __syncthreads() complete it.
__device__ __forceinline__ void stage_tile(uint8_t* s_tile, int* s_cols,
                                           const void* cpT, const int8_t* ctxT,
                                           const TileBlock& tb, int W,
                                           int unit_size, int len, int col_cap) {
  const int rows = blockDim.x;
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, len);
  if ((threadIdx.x & 31) == 0) atomicMax(s_cols, wmax);
  __syncthreads();
  const int ncols = min(*s_cols, col_cap);
  const long long first = (long long)tb.g * W * kGroupRows + tb.r0;
  stage_plane(s_tile, static_cast<const uint8_t*>(cpT) + first * unit_size,
              unit_size, ncols, rows);
  if (ctxT != nullptr)
    stage_plane(s_tile + rows * W * unit_size,
                reinterpret_cast<const uint8_t*>(ctxT) + first, 1, ncols, rows);
}

// Orders the tile's rows by length (len: the thread's own row's
// min(nu, W)); returns the row, 0..rows-1, this thread walks, so each
// warp's 32 rows are of about one length and run about as long. A bitonic
// sort of (len, row) keys in s_key (rows entries). Every thread of the
// block calls it.
__device__ __forceinline__ int sort_rows_by_length(int* s_key, int len) {
  const int t = threadIdx.x, rows = blockDim.x;
  s_key[t] = (len << 8) | t;
  __syncthreads();
  for (int k = 2; k <= rows; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int p = t ^ j;
      if (p > t) {
        const int x = s_key[t], y = s_key[p];
        if ((x > y) == ((t & k) == 0)) {
          s_key[t] = y;
          s_key[p] = x;
        }
      }
      __syncthreads();
    }
  }
  return s_key[t] & 0xFF;
}

// One row of the staged tile: column j's unit and, on a codepoint row, its
// class byte (prepare()): whether the unit earns the capitalization (bit
// 0) and delimiter (bit 1) bonus after the row's unit before it, and its
// UTF-8 byte length in bits 4-6. The classes take the tile's second
// plane, where a tile with a ctx plane staged its ctx bytes, whose bits
// 4-6 hold the same length. They depend on the row alone, so a block
// computes them once for all its queries. A byte row derives its bonus
// from its two bytes on each walk, which costs less than a class plane
// (measured on an H100: PERF.md).
template <bool UNICODE>
struct TileRow {
  const uint8_t* units;  // the row's unit in column 0
  uint8_t* cls;          // the row's class byte in column 0 (codepoints)
  int rows;
  __device__ TileRow(uint8_t* s_tile, int W, int r) {
    rows = blockDim.x;
    units = s_tile + r * (UNICODE ? 4 : 1);
    cls = s_tile + rows * W * 4 + r;
  }
  __device__ __forceinline__ int unit(int j) const {
    if (UNICODE) return reinterpret_cast<const int*>(units)[j * rows];
    return (int)units[j * rows];
  }
  // the class bytes of columns [0, len) of a codepoint row, from its
  // staged ctx bytes (has_ctx) or its derived facts; nothing on a byte row
  __device__ __forceinline__ void prepare(int len, bool has_ctx) const {
    if (!UNICODE) return;
    int prev = 0;
    for (int j = 0; j < len; ++j) {
      const int f = has_ctx ? (int)cls[j * rows] : codepoint_ctx(unit(j));
      int b = f & (7 << kCtxBlenShift);
      if (j > 0)
        b |= ((f & kCtxUpperFirst) && (prev & kCtxLowerLast) ? 1 : 0) |
             ((prev & kCtxDelimLast) && !(f & kCtxDelimFirst) ? 2 : 0);
      cls[j * rows] = (uint8_t)b;
      prev = f;
    }
  }
  __device__ __forceinline__ int blen(int j) const {
    return UNICODE ? ctx_blen(cls[j * rows]) : 1;
  }
  // the context bonus of column j > 0 after column j - 1
  __device__ __forceinline__ int bonus(int j, const Scoring& sc) const {
    if (!UNICODE) return context_bonus(byte_ctx(unit(j)), byte_ctx(unit(j - 1)), sc);
    const int b = cls[j * rows];
    return ((b & 1) ? sc.cap : 0) + ((b & 2) ? sc.delim : 0);
  }
};

// Stages the needles of the block's queries (n units each) at
// s_needle[i][k] (orig) and s_needle[i][kColstreamNeedle + k] (flip), and
// returns the bit mask of those whose group is alive. Every thread of the
// block calls it; the needles are visible after it.
__device__ __forceinline__ unsigned stage_needles(
    int (*s_needle)[2 * kColstreamNeedle], unsigned* s_alive, const int* scalars,
    const int* flags, const TileBlock& tb, int n_groups, int n) {
  const int q = tb.q0, nq = tb.q1 - tb.q0;
  for (int i = threadIdx.x; i < nq * 2 * n; i += blockDim.x) {
    const int qi = i / (2 * n), k = i - qi * 2 * n;
    const int* scal = scalars + (long long)(q + qi) * kScalars;
    s_needle[qi][k < n ? k : kColstreamNeedle + k - n] =
        scal[2 + (k < n ? k : kMaxNeedle + k - n)];
  }
  if (threadIdx.x < 32) {
    const bool a = threadIdx.x < nq &&
                   tb.alive(q + threadIdx.x, scalars, flags, n_groups);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, a);
    if (threadIdx.x == 0) *s_alive = m;
  }
  __syncthreads();
  return *s_alive;
}

}  // namespace frizbee
