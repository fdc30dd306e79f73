// Pieces shared by the package's match kernels: byte classes of the bonus
// schedule, the scoring vector, the needle scalar layout and the serving
// sort key. Header only; each .cu that includes it builds on its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace frizbee {

constexpr int kMaxNeedle = 64;  // scalars layout: [count, n, orig x 64, flip x 64]
constexpr int kScalars = 2 + 2 * kMaxNeedle;
constexpr int kMaxHaystackLen = 1024;
constexpr long long kKeySentinel = 0x7FFFFFFFFFFFFFFFLL;

struct Scoring {
  int match, mismatch, gap_open, gap_ext, prefix, cap, case_b, exact, delim;
};

inline Scoring scoring_from(const void* scoring) {
  const int* s = static_cast<const int*>(scoring);
  return Scoring{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

__device__ __forceinline__ bool is_upper(int c) { return c >= 0x41 && c <= 0x5A; }
__device__ __forceinline__ bool is_lower(int c) { return c >= 0x61 && c <= 0x7A; }
__device__ __forceinline__ bool is_delim(int c) {
  const bool letter = is_upper(c) || is_lower(c);
  const bool digit = c >= 0x30 && c <= 0x39;
  return c <= 127 && !letter && !digit;
}

// UTF-8 facts of a unit, packed as the colstream ctx plane packs them
// (frizbee_tpu_torch/corpus.py ctx_plane): bit0 is_upper(first byte), bit1
// delim(first byte), bit2 lower(last byte), bit3 delim(last byte), bits
// 4-6 the byte length.
constexpr int kCtxUpperFirst = 1, kCtxDelimFirst = 2, kCtxLowerLast = 4,
              kCtxDelimLast = 8, kCtxBlenShift = 4;

__device__ __forceinline__ int bonus_bits(int first, int last) {
  return (is_upper(first) ? kCtxUpperFirst : 0) |
         (is_delim(first) ? kCtxDelimFirst : 0) |
         (is_lower(last) ? kCtxLowerLast : 0) | (is_delim(last) ? kCtxDelimLast : 0);
}

// A byte is its own first and last byte, one byte long.
__device__ __forceinline__ int byte_ctx(int c) {
  return bonus_bits(c, c) | (1 << kCtxBlenShift);
}

// The UTF-8 length, lead byte and last byte of a codepoint.
__device__ __forceinline__ int utf8_blen(int c) {
  return 1 + (c >= 0x80) + (c >= 0x800) + (c >= 0x10000);
}
__device__ __forceinline__ int utf8_first(int c) {
  return c < 0x80 ? c
         : c < 0x800 ? (0xC0 | (c >> 6))
         : c < 0x10000 ? (0xE0 | (c >> 12))
                       : (0xF0 | (c >> 18));
}
__device__ __forceinline__ int utf8_last(int c) { return c < 0x80 ? c : (0x80 | (c & 0x3F)); }

// The UTF-8 lead and last byte and length of a codepoint, derived.
__device__ __forceinline__ int codepoint_ctx(int c) {
  return bonus_bits(utf8_first(c), utf8_last(c)) | (utf8_blen(c) << kCtxBlenShift);
}

__device__ __forceinline__ int ctx_blen(int ctx) { return (ctx >> kCtxBlenShift) & 7; }

// The bonus a unit with facts ``ctx`` earns after a unit with facts
// ``prev``: capitalization after a lowercase byte, a non-delimiter after a
// delimiter.
__device__ __forceinline__ int context_bonus(int ctx, int prev, const Scoring& sc) {
  return ((ctx & kCtxUpperFirst) && (prev & kCtxLowerLast) ? sc.cap : 0) +
         ((prev & kCtxDelimLast) && !(ctx & kCtxDelimFirst) ? sc.delim : 0);
}

// 63-bit serving key [0xFFFF - score | idx | exact, greedy, end_col];
// unmatched rows and padding (idx < 0) carry the INT64_MAX sentinel, so
// ascending order is (matched first, score desc, index asc). Shifts are
// on unsigned values (logical).
__device__ __forceinline__ long long pack_key(bool matched, int score, int exact,
                                              int end_col, int greedy, int idx,
                                              int idx_bits) {
  if (!matched || idx < 0) return kKeySentinel;
  const unsigned long long meta16 =
      ((unsigned long long)exact << 15) | ((unsigned long long)greedy << 14) |
      (unsigned long long)min(end_col, 0x3FFF);
  const unsigned long long inv = (unsigned long long)(0xFFFF - score);
  return (long long)((inv << (16 + idx_bits)) |
                     ((unsigned long long)(unsigned)idx << 16) | meta16);
}

}  // namespace frizbee
