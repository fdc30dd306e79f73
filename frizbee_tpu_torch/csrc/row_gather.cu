// Whole-row gather out[i, :] = data[rows[i], :] for Hopper (sm_90a).
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py row_gather
// (and its block_gather wrapper): there each grid step DMAs G rows of an
// unblocked HBM operand into VMEM by hand. Here one block copies one
// output row with 16-byte vector loads and stores, neighbouring threads
// on neighbouring addresses. Row lengths are multiples of 128 words, so a
// row is a whole number of int4 vectors and every row starts 512-byte
// aligned relative to the (16-byte aligned) base.
//
// Bound on this card: bytes moved, 2 * M * C * 4 over the 3.35 TB/s of
// device memory (each gathered row is read once and written once).
// Precondition: every row id lies in [0, R); the serving path's ids come
// from argsort over the matrix's rows, so the kernel does not check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const int4* __restrict__ data, const int* __restrict__ rows,
    int4* __restrict__ out, int c4) {
  const long long i = blockIdx.x;
  int4* dst = out + i * c4;
  const int4* src = data + (long long)rows[i] * c4;
  for (int c = threadIdx.x; c < c4; c += kThreads) dst[c] = src[c];
}

}  // namespace

// C entry point (bound with ctypes). data (R, C) 4-byte words with C a
// multiple of 128, rows (M,) int32 in [0, R), out (M, C). Base pointers
// must be 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int row_gather_launch(const void* data, const void* rows, void* out,
                                 int C, long long M, void* stream) {
  if (M == 0) return 0;
  row_gather_kernel<<<(unsigned)M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(data), static_cast<const int*>(rows),
      static_cast<int4*>(out), C / 4);
  return (int)cudaGetLastError();
}
