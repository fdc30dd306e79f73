// Whole-row gather out[i, :] = data[rows[i], :] for Hopper (sm_90a).
//
// Replaces the Pallas kernel frizbee_tpu/ops/colstream.py row_gather
// (and its block_gather wrapper): there each grid step DMAs G rows of an
// unblocked HBM operand into VMEM by hand. Row lengths are multiples of
// 128 words, so a row is a whole number of 16-byte vectors per lane of a
// warp and every row starts 512-byte aligned relative to the (16-byte
// aligned) base.
//
// Bound on this card: bytes moved, 2 * M * C * 4 over the 3.35 TB/s of
// device memory (each gathered row is read once and written once). A
// warp copies a 2 KB chunk of a row (1 KB for the tournament's 256-word
// rows): each lane issues all of its 16-byte loads (4, or 2) before its
// first store, so a warp keeps its whole chunk in flight. A 2048-word
// capped row is 4 chunks on 4 warps, which keeps a small gather's rows
// spread over many warps. Blocks hold up to 8 warps; a small gather takes
// fewer warps a block so its blocks still spread over all 132 SMs.
// Precondition: every row id lies in [0, R); the serving path's ids come
// from argsort over the matrix's rows, so the kernel does not check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSms = 132;  // H100 SXM

// a warp copies a chunk of 32 * VPL vectors: VPL loads a lane, then VPL
// stores; a row of C words is C / (128 * VPL) chunks
template <int VPL>
__global__ void __launch_bounds__(kMaxWarps * 32) row_gather_kernel(
    const int4* __restrict__ data, const int* __restrict__ rows,
    int4* __restrict__ out, int chunks, long long M) {
  const long long g =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= M * chunks) return;
  const long long i = g / chunks;
  const int k = (int)(g - i * chunks);
  const int lane = threadIdx.x & 31;
  const int row = __ldg(rows + i);
  const long long c4 = (long long)chunks * VPL * 32;
  const int4* src = data + row * c4 + k * VPL * 32 + lane;
  int4* dst = out + i * c4 + k * VPL * 32 + lane;
  int4 v[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) v[u] = __ldg(src + u * 32);
#pragma unroll
  for (int u = 0; u < VPL; ++u) dst[u * 32] = v[u];
}

}  // namespace

// C entry point (bound with ctypes). data (R, C) 4-byte words with C a
// multiple of 128, rows (M,) int32 in [0, R), out (M, C). Base pointers
// must be 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int row_gather_launch(const void* data, const void* rows, void* out,
                                 int C, long long M, void* stream) {
  if (M == 0) return 0;
  if (C <= 0 || C % 128) return (int)cudaErrorInvalidValue;
  const int vpl = C / 128;
  const int VPL = vpl % 4 == 0 ? 4 : (vpl % 2 == 0 ? 2 : 1);
  const int chunks = vpl / VPL;
  const long long work = M * chunks;
  int warps = kMaxWarps;
  while (warps > 1 && (work + warps - 1) / warps < 2 * kSms) warps /= 2;
  const unsigned blocks = (unsigned)((work + warps - 1) / warps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* d = static_cast<const int4*>(data);
  const int* r = static_cast<const int*>(rows);
  int4* o = static_cast<int4*>(out);
  if (VPL == 4)
    row_gather_kernel<4><<<blocks, warps * 32, 0, st>>>(d, r, o, chunks, M);
  else if (VPL == 2)
    row_gather_kernel<2><<<blocks, warps * 32, 0, st>>>(d, r, o, chunks, M);
  else
    row_gather_kernel<1><<<blocks, warps * 32, 0, st>>>(d, r, o, chunks, M);
  return (int)cudaGetLastError();
}
