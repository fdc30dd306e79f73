// The transposed-layout affine recurrence of the reference's layout probes,
// for Hopper (sm_90a): each row's best cell of a simplified column-stream
// Smith-Waterman (no prefilter, window, bonus or typo budget).
//
// Replaces the Pallas kernels of benchmarks/probe_transposed.py
// (make_transposed, pallas_call :95) and benchmarks/probe_transposed_check.py
// (kernel_raw, pallas_call :96; numpy_ref :20 is the same recurrence). There a
// grid step holds 32 x 128 rows in vector registers and walks the W unit
// columns of its (W, 32, 128) block. The block of the reference's layout
// (nB * W, 32, 128) int32 is, with no copy, (nB, W, 4096): unit j of row i
// of block b at [b, j, i], so a column of a block is 4096 contiguous units.
//
// Per row, for every column j and needle unit k (diag_in = 0 at k = 0):
//   diag = hay == needle[k] ? diag_in + 12 : max(diag_in - 6, 0)
//   cur  = max(diag, max(prev[k] - 1, 0));  best = max(best, cur)
//   diag_in = prev[k];  prev[k] = cur
// The reference also carries a row maximum (srow/left) that never reaches
// the output; it is not computed here.
//
// Bound on this card: bytes at the probe's shapes (4 bytes read a unit, 4
// written a row) against 4.5 int32 instructions a cell (chip_smoke.py
// TRANSPOSED_OPS_PER_CELL). The first design (v1 below, kept only for
// chip_smoke.py's A/B) ran a row a thread with one 4-byte load in flight,
// at 30-47% of that bound. This one:
// - A block owns a tile of 512 rows of one 4096-row block and streams its
//   columns through a shared-memory ring (column_ring.cuh: TMA bulk copies,
//   chunks of 8 columns, 4 slots, 3 chunks in flight), so the bytes in
//   flight do not depend on the launch's rows: the check's 131,072 rows
//   make 256 blocks.
// - A thread walks two neighbouring rows in the halves of 32-bit words
//   (one 8-byte shared load a column feeds both), each value + 64 in an
//   unsigned 16-bit half (column_ring.cuh kBias). Every cell is at most 12
//   n <= 192 (by induction over columns and k, prev[k] <= 12 (k + 1)), so
//   no half leaves [0, 65536) and packed 32-bit adds act per half.
// - The compares become a table: a block first writes, for each unit value
//   in [0, 256), a byte a needle unit (its diagonal operand + 6: 18 on a
//   hit, 0 on a miss; the HitWords layout of column_ring.cuh). A pair's
//   operand d of unit k is one prmt of the two rows' words, and the cell
//   is two packed adds and one 3-input DPX max:
//     cur = max(diag_in + d - 6, prev[k] - 1, 0)
//   which is the recurrence above: a hit's diag_in + 12 exceeds
//   relu(diag_in - 6), and a miss's diag_in - 6 is that relu once 0 is in
//   the max. best takes two cells a 3-input max. Units outside [0, 256)
//   take the table's no-unit entry when every needle unit lies inside;
//   else (a needle unit outside) the kernel walks a path whose outside
//   units compute their bytes (exact for every int32 unit).
// - Issue: the prmt and the max run on one pipe at 64 lanes an SM a clock
//   (as do DPX add-max and 32-bit max; measured, pipe_rates.py), the adds
//   on either integer pipe, so a pair's cell takes about 2.5 slots of that
//   pipe, where DPX add-max for the adds would take 4.5.
// - The cells of a column depend only on the previous column, so a pair
//   offers n independent chains and a column's loads issue ahead of them.

#include "column_ring.cuh"
#include "kernel_common.cuh"

namespace {

constexpr int kBlockRows = 32 * 128;  // rows of one block of the layout

namespace v1 {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) probe_transposed_kernel(
    const int* __restrict__ cpT, const int* __restrict__ scal, int* __restrict__ out,
    long long rows, int W) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const long long b = r / kBlockRows;
  const int* col = cpT + b * W * (long long)kBlockRows + (r - b * kBlockRows);
  int needle[N], prev[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    needle[k] = __ldg(scal + 2 + k);
    prev[k] = 0;
  }
  int best = 0;
  for (int j = 0; j < W; ++j) {
    const int hay = __ldg(col + (long long)j * kBlockRows);
    int diag_in = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int diag = hay == needle[k] ? diag_in + 12 : max(diag_in - 6, 0);
      const int cur = max(diag, max(prev[k] - 1, 0));
      best = max(best, cur);
      diag_in = prev[k];
      prev[k] = cur;
    }
  }
  out[r] = best;
}

template <int N>
void launch(const int* cpT, const int* scal, int* out, long long rows, int W,
            cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  probe_transposed_kernel<N><<<blocks, kThreads, 0, st>>>(cpT, scal, out, rows, W);
}

}  // namespace v1

// the ring design's geometry (probes/transposed.py ring_geometry mirrors it)
constexpr int kThreads = 256;
constexpr int kTileRows = 2 * kThreads;  // two rows a thread
constexpr int kChunkCols = 8;
constexpr int kRingStages = 4;
constexpr int kMinBlocks = 3;  // blocks an SM (the shared memory holds 3)
constexpr int kTilesPerBlock = kBlockRows / kTileRows;
using Ring = frizbee::ColumnRing<kTileRows, kChunkCols, kRingStages>;

// the table's bytes: the diagonal operand + 6 (+12 on a hit, -6 else)
constexpr uint32_t kHit = 18, kMiss = 0;
constexpr uint32_t kOne = 0x00010001u, kSix = 0x00060006u;  // per half

template <int N>
constexpr int smem_bytes() {
  return Ring::kBytes + frizbee::kTableUnits * frizbee::HitWords<N>::kWords * 4;
}

// unit u's words: the table entry, or (BIG: some needle unit lies outside
// the table, and so does u) the bytes computed from the needle
template <int N, int NW, bool BIG>
__device__ __forceinline__ void unit_words(int u, const uint32_t* tab, const int* s_needle,
                                           uint32_t (&w)[NW]) {
  const int idx = frizbee::table_index(u);
  if (BIG && idx == frizbee::kNoUnit) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = kMiss * 0x01010101u;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (u == s_needle[k]) w[k >> 2] |= kHit << (8 * (k & 3));
  } else {
    frizbee::load_words<NW>(tab + idx * NW, w);
  }
}

// One column of a pair: the cells of every needle unit, best updated. In
// each half, + kBias: cur = max(diag_in + d - 6, prev - 1, 0).
template <int N, int NW, bool BIG>
__device__ __forceinline__ void column(const int* col, const uint32_t* tab,
                                       const int* s_needle, uint32_t (&prev)[N],
                                       uint32_t& best) {
  const int2 u = *reinterpret_cast<const int2*>(col + 2 * threadIdx.x);
  uint32_t lo[NW], hi[NW];
  unit_words<N, NW, BIG>(u.x, tab, s_needle, lo);
  unit_words<N, NW, BIG>(u.y, tab, s_needle, hi);
  uint32_t diag_in = frizbee::kBias, held = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t d = frizbee::hit_pair<NW>(k, lo, hi);
    const uint32_t cur = __vimax3_u16x2(diag_in + d - kSix, prev[k] - kOne, frizbee::kBias);
    diag_in = prev[k];
    prev[k] = cur;
    if (k & 1) {
      best = __vimax3_u16x2(best, held, cur);
    } else if (k == N - 1) {
      best = __vimax3_u16x2(best, cur, cur);
    } else {
      held = cur;
    }
  }
}

template <int N, bool BIG>
__device__ __forceinline__ uint32_t walk(const Ring& ring, const uint32_t* tab,
                                         const int* s_needle) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  uint32_t prev[N];
#pragma unroll
  for (int k = 0; k < N; ++k) prev[k] = frizbee::kBias;
  uint32_t best = frizbee::kBias;
  // the first chunk's barrier also publishes the table and the needle
  ring.walk<!BIG>([&](const int* col, int) {
    column<N, NW, BIG>(col, tab, s_needle, prev, best);
  });
  return best;
}

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks) probe_transposed_ring_kernel(
    const int* __restrict__ cpT, const int* __restrict__ scal, int* __restrict__ out, int W) {
  constexpr int NW = frizbee::HitWords<N>::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_needle[N];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + Ring::kBytes);
  const int b = blockIdx.x / kTilesPerBlock;
  const int r0 = (blockIdx.x - b * kTilesPerBlock) * kTileRows;
  const Ring ring(reinterpret_cast<int*>(smem),
                  cpT + (long long)b * W * kBlockRows + r0, kBlockRows, W);
  ring.start();
  bool big = false;
#pragma unroll
  for (int k = 0; k < N; ++k) big |= frizbee::outside_table(__ldg(scal + 2 + k));
  if (threadIdx.x < N) s_needle[threadIdx.x] = __ldg(scal + 2 + threadIdx.x);
  for (int e = threadIdx.x; e < frizbee::kTableUnits * NW; e += kThreads) {
    const int u = e / NW, w = e - u * NW;
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * w + i;
      const bool hit = k < N && u < frizbee::kNoUnit && u == __ldg(scal + 2 + k);
      word |= (hit ? kHit : kMiss) << (8 * i);
    }
    tab[e] = word;
  }
  const uint32_t best = big ? walk<N, true>(ring, tab, s_needle)
                            : walk<N, false>(ring, tab, s_needle);
  *reinterpret_cast<int2*>(out + (long long)b * kBlockRows + r0 + 2 * threadIdx.x) =
      make_int2(frizbee::half_lo(best - frizbee::kBias),
                frizbee::half_hi(best - frizbee::kBias));
}

template <int N>
int launch(const int* cpT, const int* scal, int* out, int n_blocks, int W, cudaStream_t st) {
  auto kernel = probe_transposed_ring_kernel<N>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<N>());
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)n_blocks * kTilesPerBlock, kThreads, smem_bytes<N>(), st>>>(cpT, scal,
                                                                                 out, W);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). cpT (n_blocks * W, 32, 128) int32
// units, 16-byte aligned; scal the (130,) int32 needle scalars ([count, n,
// orig x 64, flip x 64]; the needle is orig[0:n]), out (n_blocks * 32, 128)
// int32 per-row best. 1 <= n <= 16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it refuses).
extern "C" int probe_transposed_launch(const void* cpT, const void* scal, void* out,
                                       int n_blocks, int W, int n, void* stream) {
  if (n_blocks < 0 || W < 0 || n < 1 || n > 16 || ((uintptr_t)cpT & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const int* c = static_cast<const int*>(cpT);
  const int* s = static_cast<const int*>(scal);
  int* o = static_cast<int*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define PROBE_TRANSPOSED_CASE(N) \
  case N:                        \
    return launch<N>(c, s, o, n_blocks, W, st);
    PROBE_TRANSPOSED_CASE(1) PROBE_TRANSPOSED_CASE(2) PROBE_TRANSPOSED_CASE(3)
    PROBE_TRANSPOSED_CASE(4) PROBE_TRANSPOSED_CASE(5) PROBE_TRANSPOSED_CASE(6)
    PROBE_TRANSPOSED_CASE(7) PROBE_TRANSPOSED_CASE(8) PROBE_TRANSPOSED_CASE(9)
    PROBE_TRANSPOSED_CASE(10) PROBE_TRANSPOSED_CASE(11) PROBE_TRANSPOSED_CASE(12)
    PROBE_TRANSPOSED_CASE(13) PROBE_TRANSPOSED_CASE(14) PROBE_TRANSPOSED_CASE(15)
    PROBE_TRANSPOSED_CASE(16)
#undef PROBE_TRANSPOSED_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The first design (a row a thread, one 4-byte load in flight), with the
// same arguments and results; only chip_smoke.py's A/B calls it.
extern "C" int probe_transposed_v1_launch(const void* cpT, const void* scal, void* out,
                                          int n_blocks, int W, int n, void* stream) {
  if (n_blocks < 0 || W < 0 || n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_blocks * kBlockRows;
  if (rows == 0) return 0;
  const int* c = static_cast<const int*>(cpT);
  const int* s = static_cast<const int*>(scal);
  int* o = static_cast<int*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define PROBE_TRANSPOSED_CASE(N) \
  case N:                        \
    v1::launch<N>(c, s, o, rows, W, st); \
    break;
    PROBE_TRANSPOSED_CASE(1) PROBE_TRANSPOSED_CASE(2) PROBE_TRANSPOSED_CASE(3)
    PROBE_TRANSPOSED_CASE(4) PROBE_TRANSPOSED_CASE(5) PROBE_TRANSPOSED_CASE(6)
    PROBE_TRANSPOSED_CASE(7) PROBE_TRANSPOSED_CASE(8) PROBE_TRANSPOSED_CASE(9)
    PROBE_TRANSPOSED_CASE(10) PROBE_TRANSPOSED_CASE(11) PROBE_TRANSPOSED_CASE(12)
    PROBE_TRANSPOSED_CASE(13) PROBE_TRANSPOSED_CASE(14) PROBE_TRANSPOSED_CASE(15)
    PROBE_TRANSPOSED_CASE(16)
#undef PROBE_TRANSPOSED_CASE
  }
  return (int)cudaGetLastError();
}
