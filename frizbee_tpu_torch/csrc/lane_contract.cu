// The lane contract kernel: one launch that evaluates, on the card, every
// device helper the match kernels build on, so each is held against its
// plain model (ops/contract.contract_plain) bit for bit.
//
// Replaces two TPU kernels of the reference: the lane-helper harness of
// tests/test_kernel_contract.py (run_in_kernel, which runs frizbee_tpu's
// lane primitives inside a pallas_call against NumPy models, in int32 and
// int16 lanes) and the op-lowering half of
// benchmarks/probe_colstream_int16.py (which 16-bit vector operations a
// target lowers: compare-select, add, max, shift). What runs here:
//
// - rows: per row of x (values), p (summands) and u (units) with a shift
//   distance d, a fill, a gather lane, a unit count nu and a codepoint
//   flag, once in int32 and once in int16: the shift right by d with the
//   fill (_shift_right), the inclusive prefix sum of p (_cumsum_lanes),
//   the running maximum of x (_cummax_lanes), x at the gather lane
//   (_gather_lane), the row minimum and maximum (_rmin, _rmax), and
//   _unit_context's first byte, previous last byte, byte offset (the
//   exclusive prefix sum of byte lengths), byte length and byte count of
//   the row's first nu units, with utf8_blen, utf8_first and utf8_last
//   (kernel_common.cuh) on codepoint rows;
// - units: is_upper, is_lower, is_delim, byte_ctx, codepoint_ctx and its
//   ctx_blen (kernel_common.cuh) of each value;
// - pairs: bonus_bits(first, last) and context_bonus(ctx, prev) of each
//   (x, y);
// - keys: pack_key of each (matched, score, exact, end_col, greedy, idx,
//   idx_bits);
// - words: every s16x2 operation of the int16-lane kernels (lanes16.cuh)
//   on packed words a..f and a unit index k: __viaddmax_s16x2 and its relu
//   form, __vimax3_s16x2 and its relu form, __vibmax_s16x2 with its two
//   predicates, half_masks (32- and 64-bit masks) and half_masks16, pair16
//   and pair16_high, PairBits (a unit's half masks of two rows' merged
//   16- and 64-unit masks), sel2, hit2 (the per-half match score), cell2
//   (the DP cell) and best2 (the running best and which halves it raised), at
//   the int16 values the DP reaches and at sums that cross +-32767.
//
// Bound on this card: the launch. The work is about 2 MB of inputs and
// outputs and a few dozen operations an item (0.6 us at the memory rate),
// less than an empty launch of the same grid costs. So the design keeps
// every step off a serial chain of device-memory round trips:
//
// - the row walks get their own blocks at the start of the grid, a warp a
//   (row, lane type): each thread holds four consecutive lanes of x, p and
//   u (16-byte loads), and the reference's cross-lane primitives become
//   warp shuffles: the shift and the previous last byte read the source
//   lane's register, the prefix sums and the running maximum are a serial
//   walk over the thread's four lanes and a shuffle scan over the warp
//   (sums in 32-bit unsigned arithmetic, cast to the lane type: a 16-bit
//   lane's wrapped sum is the low half of the 32-bit one, so this is
//   bit-equal to a walk that wraps at every lane), the minimum and maximum
//   are warp reductions; each of the row's seven planes goes out as one
//   16-byte store a thread;
// - the units, pairs, keys and words stay one thread an item, grid-stride
//   over tiles of kTile items: a tile's inputs are staged in shared memory
//   with coalesced loads, each thread writes its item's outputs to shared
//   memory, and the tile's outputs leave with coalesced stores (on an
//   H100 the whole launch takes about two thirds of its time with the
//   items loaded and stored in place, a thread an item).

#include "lanes16.cuh"

namespace {

constexpr int kUnitOut = 6;
constexpr int kPairIn = 2;
constexpr int kPairOut = 2;
constexpr int kKeyIn = 7;
constexpr int kKeyOut = 2;  // one int64 key, as two 32-bit words
constexpr int kWordIn = 7;
constexpr int kWordOut = 17;
constexpr int kRowLanes = 128;
constexpr int kRowIn = 3;    // x, p, u
constexpr int kRowArgs = 5;  // d, fill, gather lane, nu, codepoint row
// shift, prefix sum, running max, first, prev, offset, length (a lane
// each), then gather, min, max, byte count
constexpr int kRowOut = 7 * kRowLanes + 4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // items a flat tile
constexpr int kMaxIn = kWordIn, kMaxOut = kWordOut;
constexpr unsigned kFull = 0xFFFFFFFFu;

// A value of lane type L, sign-extended back to int.
template <typename L>
__device__ __forceinline__ int as_lane(int v) {
  return (int)(L)v;
}

// Register k of four, k the same in every thread of the warp.
__device__ __forceinline__ int pick4(const int (&r)[4], int k) {
  return k == 0 ? r[0] : k == 1 ? r[1] : k == 2 ? r[2] : r[3];
}

// Inclusive scans over the warp of one value a thread.
__device__ __forceinline__ unsigned warp_sum_incl(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}
__device__ __forceinline__ int warp_max_incl(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, t);
  }
  return v;
}

// One row in lane type L, walked by a warp: this thread holds lanes
// j0..j0+3 (j0 = 4 * lane). Every result is stored as L, sign-extended.
template <typename L>
__device__ void row_lanes(const int* __restrict__ in, const int* __restrict__ args,
                          int* __restrict__ o, int lane) {
  const int4 xv = reinterpret_cast<const int4*>(in)[lane];
  const int4 pv = reinterpret_cast<const int4*>(in + kRowLanes)[lane];
  const int4 uv = reinterpret_cast<const int4*>(in + 2 * kRowLanes)[lane];
  const int d = args[0], fill = as_lane<L>(args[1]), at_lane = args[2], nu = args[3];
  const bool unicode = args[4] != 0;
  const int j0 = 4 * lane;
  const int v[4] = {as_lane<L>(xv.x), as_lane<L>(xv.y), as_lane<L>(xv.z),
                    as_lane<L>(xv.w)};
  const unsigned p[4] = {(unsigned)pv.x, (unsigned)pv.y, (unsigned)pv.z,
                         (unsigned)pv.w};
  const int u[4] = {uv.x, uv.y, uv.z, uv.w};

  // shift right by d: lane j reads lane j - d, whose slot (j - d) & 3 is
  // the same in every thread
  int sh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = j0 + k - d;
    const int got = __shfl_sync(kFull, pick4(v, (k - d) & 3), (src >> 2) & 31);
    sh[k] = j0 + k >= d ? got : fill;
  }

  // inclusive prefix sum of p and running maximum of x: the thread's four
  // lanes serially, then the warp's scan of the threads' totals
  unsigned sum[4];
  int run[4];
  sum[0] = p[0];
  run[0] = v[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    sum[k] = sum[k - 1] + p[k];
    run[k] = max(run[k - 1], v[k]);
  }
  const unsigned sum_before = warp_sum_incl(sum[3], lane) - sum[3];
  const int run_incl = warp_max_incl(run[3], lane);
  const int run_before = __shfl_up_sync(kFull, run_incl, 1);
  const int lo = __reduce_min_sync(kFull, min(min(v[0], v[1]), min(v[2], v[3])));
  const int hi = __reduce_max_sync(kFull, max(max(v[0], v[1]), max(v[2], v[3])));
  const bool at_ok = at_lane >= 0 && at_lane < kRowLanes;
  const int at_got = __shfl_sync(kFull, pick4(v, at_lane & 3), (at_lane >> 2) & 31);
  const int at = at_ok ? at_got : 0;

  // _unit_context: lead byte, previous unit's last byte, byte offset and
  // byte length of each of the first nu units
  int first[4], last[4], blen[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = unicode ? u[k] : (u[k] & 0xFF);
    const bool valid = j0 + k < nu;
    blen[k] = valid ? (unicode ? frizbee::utf8_blen(c) : 1) : 0;
    first[k] = valid ? as_lane<L>(unicode ? frizbee::utf8_first(c) : c) : 0;
    last[k] = as_lane<L>(unicode ? frizbee::utf8_last(c) : c);
  }
  const int last_before = __shfl_up_sync(kFull, last[3], 1);
  const unsigned bsum = (unsigned)(blen[0] + blen[1] + blen[2] + blen[3]);
  const unsigned bincl = warp_sum_incl(bsum, lane);
  unsigned boff = bincl - bsum;
  int prev[4], off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool valid = j0 + k < nu;
    const int pl = k > 0 ? last[k - 1] : (lane > 0 ? last_before : as_lane<L>(-1));
    prev[k] = valid ? pl : as_lane<L>(-1);
    off[k] = valid ? as_lane<L>((int)boff) : 0;
    boff += (unsigned)blen[k];
  }

  int4* out = reinterpret_cast<int4*>(o) + lane;
  constexpr int kPlane = kRowLanes / 4;  // int4s a plane
  out[0] = make_int4(sh[0], sh[1], sh[2], sh[3]);
  int s[4], r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = as_lane<L>((int)(sum_before + sum[k]));
    r[k] = lane > 0 ? max(run_before, run[k]) : run[k];
  }
  out[kPlane] = make_int4(s[0], s[1], s[2], s[3]);
  out[2 * kPlane] = make_int4(r[0], r[1], r[2], r[3]);
  out[3 * kPlane] = make_int4(first[0], first[1], first[2], first[3]);
  out[4 * kPlane] = make_int4(prev[0], prev[1], prev[2], prev[3]);
  out[5 * kPlane] = make_int4(off[0], off[1], off[2], off[3]);
  out[6 * kPlane] = make_int4(blen[0], blen[1], blen[2], blen[3]);
  const int total = __shfl_sync(kFull, (int)bincl, 31);
  if (lane == 0)
    reinterpret_cast<int4*>(o + 7 * kRowLanes)[0] =
        make_int4(at, lo, hi, as_lane<L>(total));
}

// One tile of a flat segment: the tile's inputs (IW words an item) staged
// in shared memory with coalesced loads, item i's outputs (OW words)
// written by thread i to shared memory by f, then stored coalesced.
template <int IW, int OW, typename F>
__device__ void tile_pass(const int* __restrict__ in, int* __restrict__ out, int n, int tile,
                          int* s_in, int* s_out, F f) {
  const long long base = (long long)tile * kTile;
  const int cnt = min(kTile, (int)(n - base));
  const int* src = in + base * IW;
  for (int k = threadIdx.x; k < cnt * IW; k += kThreads) s_in[k] = src[k];
  __syncthreads();
  if ((int)threadIdx.x < cnt) f(s_in + threadIdx.x * IW, s_out + threadIdx.x * OW);
  __syncthreads();
  int* dst = out + base * OW;
  for (int k = threadIdx.x; k < cnt * OW; k += kThreads) dst[k] = s_out[k];
  __syncthreads();  // the next tile reuses s_in and s_out
}

__host__ __device__ __forceinline__ int tiles(int n) { return (n + kTile - 1) / kTile; }

__global__ void __launch_bounds__(kThreads)
    lane_contract_kernel(const int* __restrict__ units, int n_units,
                         const int* __restrict__ pairs, int n_pairs,
                         const int* __restrict__ keys, int n_keys,
                         const unsigned* __restrict__ words, int n_words,
                         const int* __restrict__ rows, const int* __restrict__ row_args,
                         int n_rows, int row_blocks, frizbee::Scoring sc,
                         int* __restrict__ units_out, int* __restrict__ pairs_out,
                         long long* __restrict__ keys_out, unsigned* __restrict__ words_out,
                         int* __restrict__ rows_out) {
  if ((int)blockIdx.x < row_blocks) {
    // a warp a (row, lane type): the first n_rows in int32, the next
    // n_rows in int16
    const int r = blockIdx.x * kWarps + threadIdx.x / 32;
    if (r >= 2 * n_rows) return;
    const int row = r % n_rows;
    const int* in = rows + (long long)row * kRowIn * kRowLanes;
    const int* args = row_args + (long long)row * kRowArgs;
    int* o = rows_out + (long long)r * kRowOut;
    if (r < n_rows)
      row_lanes<int>(in, args, o, threadIdx.x % 32);
    else
      row_lanes<short>(in, args, o, threadIdx.x % 32);
    return;
  }
  __shared__ int s_in[kTile * kMaxIn];
  __shared__ int s_out[kTile * kMaxOut];
  const int t_units = tiles(n_units), t_pairs = tiles(n_pairs), t_keys = tiles(n_keys);
  const int total = t_units + t_pairs + t_keys + tiles(n_words);
  const int stride = (int)gridDim.x - row_blocks;
  for (int t = (int)blockIdx.x - row_blocks; t < total; t += stride) {
    if (t < t_units) {
      tile_pass<1, kUnitOut>(units, units_out, n_units, t, s_in, s_out,
                             [](const int* i, int* o) {
                               const int c = i[0];
                               const int cp = frizbee::codepoint_ctx(c);
                               o[0] = frizbee::is_upper(c);
                               o[1] = frizbee::is_lower(c);
                               o[2] = frizbee::is_delim(c);
                               o[3] = frizbee::byte_ctx(c);
                               o[4] = cp;
                               o[5] = frizbee::ctx_blen(cp);
                             });
      continue;
    }
    int u = t - t_units;
    if (u < t_pairs) {
      tile_pass<kPairIn, kPairOut>(pairs, pairs_out, n_pairs, u, s_in, s_out,
                                   [=](const int* i, int* o) {
                                     o[0] = frizbee::bonus_bits(i[0], i[1]);
                                     o[1] = frizbee::context_bonus(i[0], i[1], sc);
                                   });
      continue;
    }
    u -= t_pairs;
    if (u < t_keys) {
      tile_pass<kKeyIn, kKeyOut>(keys, reinterpret_cast<int*>(keys_out), n_keys, u, s_in,
                                 s_out, [](const int* k, int* o) {
                                   const long long key = frizbee::pack_key(
                                       k[0] != 0, k[1], k[2], k[3], k[4], k[5], k[6]);
                                   o[0] = (int)(unsigned)key;
                                   o[1] = (int)(unsigned)((unsigned long long)key >> 32);
                                 });
      continue;
    }
    u -= t_keys;
    tile_pass<kWordIn, kWordOut>(
        reinterpret_cast<const int*>(words), reinterpret_cast<int*>(words_out), n_words, u,
        s_in, s_out, [](const int* wi, int* oi) {
          const unsigned* w = reinterpret_cast<const unsigned*>(wi);
          unsigned* o = reinterpret_cast<unsigned*>(oi);
          const unsigned a = w[0], b = w[1], c = w[2], d = w[3], e = w[4], f = w[5];
          const int k = (int)w[6];
          bool ph, pl;
          o[0] = __viaddmax_s16x2(a, b, c);
          o[1] = __viaddmax_s16x2_relu(a, b, c);
          o[2] = __vimax3_s16x2(a, b, c);
          o[3] = __vimax3_s16x2_relu(a, b, c);
          o[4] = __vibmax_s16x2(a, b, &ph, &pl);
          o[5] = (pl ? 1u : 0u) | (ph ? 2u : 0u);
          o[6] = frizbee::half_masks(a, b, k & 31);
          o[7] = frizbee::half_masks16(a, k & 15);
          o[8] = frizbee::pair16(a, b);
          o[9] = frizbee::pair16_high(a, b);
          o[10] = frizbee::sel2(c, a, b);
          o[11] = frizbee::hit2(a, b, c, d, e);
          o[12] = frizbee::cell2(a, b, c, d, e, f);
          o[13] = frizbee::PairBits<64>(
                      (unsigned long long)a | ((unsigned long long)b << 32),
                      (unsigned long long)c | ((unsigned long long)d << 32))
                      .mask(k & 63);
          o[14] = frizbee::PairBits<16>(a, b).mask(k & 15);
          int raised;
          o[15] = frizbee::best2(a, b, &raised);
          o[16] = (unsigned)raised;
        });
  }
}

// The grid of a launch: the row blocks, then the flat blocks (one a tile,
// at most 1024, grid-stride past that).
void contract_grid(int n_units, int n_pairs, int n_keys, int n_words, int n_rows,
                   int* row_blocks, int* blocks) {
  const int flat = tiles(n_units) + tiles(n_pairs) + tiles(n_keys) + tiles(n_words);
  *row_blocks = (2 * n_rows + kWarps - 1) / kWarps;
  *blocks = *row_blocks + (flat < 1024 ? flat : 1024);
}

__global__ void empty_kernel() {}

}  // namespace

// C entry point (bound with ctypes). units (n_units,) int32; pairs
// (n_pairs, 2) int32; keys (n_keys, 7) int32; words (n_words, 7) 32-bit
// words (a..f, k); rows (n_rows, 3, 128) int32 (x, p, u); row_args
// (n_rows, 5) int32 (d in 1..127, fill, gather lane in 0..127, nu in
// 0..128, codepoint flag); scoring (9,) host int32. Writes units_out
// (n_units, 6) int32, pairs_out (n_pairs, 2) int32, keys_out (n_keys,)
// int64, words_out (n_words, 17) 32-bit words and rows_out (2, n_rows,
// 900) int32 (int32 lanes, then int16 lanes), in the order the kernel
// lists them. Every pointer 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int lane_contract_launch(const void* units, int n_units, const void* pairs,
                                    int n_pairs, const void* keys, int n_keys,
                                    const void* words, int n_words, const void* rows,
                                    const void* row_args, int n_rows, const void* scoring,
                                    void* units_out, void* pairs_out, void* keys_out,
                                    void* words_out, void* rows_out, void* stream) {
  if (n_units < 0 || n_pairs < 0 || n_keys < 0 || n_words < 0 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  int row_blocks, blocks;
  contract_grid(n_units, n_pairs, n_keys, n_words, n_rows, &row_blocks, &blocks);
  if (blocks == 0) return 0;
  lane_contract_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(units), n_units, static_cast<const int*>(pairs), n_pairs,
      static_cast<const int*>(keys), n_keys, static_cast<const unsigned*>(words), n_words,
      static_cast<const int*>(rows), static_cast<const int*>(row_args), n_rows, row_blocks,
      frizbee::scoring_from(scoring), static_cast<int*>(units_out),
      static_cast<int*>(pairs_out), static_cast<long long*>(keys_out),
      static_cast<unsigned*>(words_out), static_cast<int*>(rows_out));
  return (int)cudaGetLastError();
}

// The launch floor of the contract: an empty kernel on the grid that
// lane_contract_launch would take for these counts (timed beside it by
// chip_smoke.py's contract phase; no path launches it). Returns
// cudaGetLastError() after the launch.
extern "C" int lane_contract_empty_launch(int n_units, int n_pairs, int n_keys, int n_words,
                                          int n_rows, void* stream) {
  int row_blocks, blocks;
  contract_grid(n_units, n_pairs, n_keys, n_words, n_rows, &row_blocks, &blocks);
  if (blocks == 0) return 0;
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
