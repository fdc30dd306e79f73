// The lane contract kernel: one launch that evaluates, on the card, every
// device helper the match kernels build on, so each is held against its
// plain model (ops/contract.contract_plain) bit for bit.
//
// Replaces two TPU kernels of the reference: the lane-helper harness of
// tests/test_kernel_contract.py (run_in_kernel, which runs frizbee_tpu's
// lane primitives inside a pallas_call against NumPy models, in int32 and
// int16 lanes) and the op-lowering half of
// benchmarks/probe_colstream_int16.py (which 16-bit vector operations a
// target lowers: compare-select, add, max, shift). Here a thread is a lane:
// the reference's cross-lane primitives (lane shifts, prefix sums and
// maxima, lane gathers and reductions) become the serial walk a thread
// makes along its row, run here over rows of 128 lanes in int32 and in
// int16 arithmetic. What runs here:
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
// Bound on this card: nothing that matters; the launch is a few thousand
// threads of a few dozen operations each (a row thread walks 128 lanes).
// It exists for its results.

#include "lanes16.cuh"

namespace {

constexpr int kUnitOut = 6;
constexpr int kPairOut = 2;
constexpr int kKeyIn = 7;
constexpr int kWordIn = 7;
constexpr int kWordOut = 17;
constexpr int kRowLanes = 128;
constexpr int kRowIn = 3;    // x, p, u
constexpr int kRowArgs = 5;  // d, fill, gather lane, nu, codepoint row
// shift, prefix sum, running max, first, prev, offset, length (a lane
// each), then gather, min, max, byte count
constexpr int kRowOut = 7 * kRowLanes + 4;

// One row walked serially in lane type L, as a match kernel's thread walks
// its row; every result is stored as L, sign-extended.
template <typename L>
__device__ void row_lanes(const int* __restrict__ in, const int* __restrict__ args,
                          int* __restrict__ o) {
  const int* x = in;
  const int* p = in + kRowLanes;
  const int* u = in + 2 * kRowLanes;
  const int d = args[0], at_lane = args[2], nu = args[3];
  const L fill = (L)args[1];
  const bool unicode = args[4] != 0;
  L sum = 0, run = (L)x[0], lo = (L)x[0], hi = (L)x[0], at = 0, prev = -1, boff = 0;
  for (int j = 0; j < kRowLanes; ++j) {
    const L v = (L)x[j];
    o[j] = j >= d ? (L)x[j - d] : fill;
    sum = (L)(sum + (L)p[j]);
    o[kRowLanes + j] = sum;
    run = v > run ? v : run;
    o[2 * kRowLanes + j] = run;
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
    if (j == at_lane) at = v;
    const bool valid = j < nu;
    const int c = unicode ? u[j] : (u[j] & 0xFF);
    const L blen = valid ? (L)(unicode ? frizbee::utf8_blen(c) : 1) : (L)0;
    o[3 * kRowLanes + j] = valid ? (L)(unicode ? frizbee::utf8_first(c) : c) : (L)0;
    o[4 * kRowLanes + j] = valid ? prev : (L)-1;
    o[5 * kRowLanes + j] = valid ? boff : (L)0;
    o[6 * kRowLanes + j] = blen;
    prev = (L)(unicode ? frizbee::utf8_last(c) : c);
    boff = (L)(boff + blen);
  }
  o[7 * kRowLanes] = at;
  o[7 * kRowLanes + 1] = lo;
  o[7 * kRowLanes + 2] = hi;
  o[7 * kRowLanes + 3] = boff;
}

__global__ void lane_contract_kernel(const int* __restrict__ units, int n_units,
                                     const int* __restrict__ pairs, int n_pairs,
                                     const int* __restrict__ keys, int n_keys,
                                     const unsigned* __restrict__ words, int n_words,
                                     const int* __restrict__ rows,
                                     const int* __restrict__ row_args, int n_rows,
                                     frizbee::Scoring sc, int* __restrict__ units_out,
                                     int* __restrict__ pairs_out,
                                     long long* __restrict__ keys_out,
                                     unsigned* __restrict__ words_out,
                                     int* __restrict__ rows_out) {
  const int total = n_units + n_pairs + n_keys + n_words + 2 * n_rows;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    if (i < n_units) {
      const int c = units[i];
      int* o = units_out + (long long)i * kUnitOut;
      const int cp = frizbee::codepoint_ctx(c);
      o[0] = frizbee::is_upper(c);
      o[1] = frizbee::is_lower(c);
      o[2] = frizbee::is_delim(c);
      o[3] = frizbee::byte_ctx(c);
      o[4] = cp;
      o[5] = frizbee::ctx_blen(cp);
      continue;
    }
    int r = i - n_units;
    if (r < n_pairs) {
      const int x = pairs[2 * r], y = pairs[2 * r + 1];
      pairs_out[kPairOut * r] = frizbee::bonus_bits(x, y);
      pairs_out[kPairOut * r + 1] = frizbee::context_bonus(x, y, sc);
      continue;
    }
    r -= n_pairs;
    if (r < n_keys) {
      const int* k = keys + (long long)r * kKeyIn;
      keys_out[r] = frizbee::pack_key(k[0] != 0, k[1], k[2], k[3], k[4], k[5], k[6]);
      continue;
    }
    r -= n_keys;
    if (r >= n_words) {
      // rows: the first n_rows threads in int32, the next n_rows in int16
      r -= n_words;
      const int row = r % n_rows;
      const int* in = rows + (long long)row * kRowIn * kRowLanes;
      const int* args = row_args + (long long)row * kRowArgs;
      int* o = rows_out + (long long)r * kRowOut;
      if (r < n_rows)
        row_lanes<int>(in, args, o);
      else
        row_lanes<short>(in, args, o);
      continue;
    }
    const unsigned* w = words + (long long)r * kWordIn;
    const unsigned a = w[0], b = w[1], c = w[2], d = w[3], e = w[4], f = w[5];
    const int k = (int)w[6];
    unsigned* o = words_out + (long long)r * kWordOut;
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
  }
}

}  // namespace

// C entry point (bound with ctypes). units (n_units,) int32; pairs
// (n_pairs, 2) int32; keys (n_keys, 7) int32; words (n_words, 7) 32-bit
// words (a..f, k); rows (n_rows, 3, 128) int32 (x, p, u); row_args
// (n_rows, 5) int32 (d in 1..127, fill, gather lane in 0..127, nu in
// 0..128, codepoint flag); scoring (9,) host int32. Writes units_out
// (n_units, 6) int32, pairs_out (n_pairs, 2) int32, keys_out (n_keys,)
// int64, words_out (n_words, 17) 32-bit words and rows_out (2, n_rows,
// 900) int32 (int32 lanes, then int16 lanes), in the order the kernel
// lists them. Returns cudaGetLastError() after the launch.
extern "C" int lane_contract_launch(const void* units, int n_units, const void* pairs,
                                    int n_pairs, const void* keys, int n_keys,
                                    const void* words, int n_words, const void* rows,
                                    const void* row_args, int n_rows, const void* scoring,
                                    void* units_out, void* pairs_out, void* keys_out,
                                    void* words_out, void* rows_out, void* stream) {
  const int total = n_units + n_pairs + n_keys + n_words + 2 * n_rows;
  if (total == 0) return 0;
  if (n_units < 0 || n_pairs < 0 || n_keys < 0 || n_words < 0 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int need = (total + threads - 1) / threads;
  const int blocks = need < 1024 ? need : 1024;
  lane_contract_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(units), n_units, static_cast<const int*>(pairs), n_pairs,
      static_cast<const int*>(keys), n_keys, static_cast<const unsigned*>(words), n_words,
      static_cast<const int*>(rows), static_cast<const int*>(row_args), n_rows,
      frizbee::scoring_from(scoring), static_cast<int*>(units_out),
      static_cast<int*>(pairs_out), static_cast<long long*>(keys_out),
      static_cast<unsigned*>(words_out), static_cast<int*>(rows_out));
  return (int)cudaGetLastError();
}
