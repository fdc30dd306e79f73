// The transposed-layout affine recurrence of the reference's layout probes,
// for Hopper (sm_90a): each row's best cell of a simplified column-stream
// Smith-Waterman (no prefilter, window, bonus or typo budget).
//
// Replaces the Pallas kernels of benchmarks/probe_transposed.py
// (make_transposed, pallas_call :95) and benchmarks/probe_transposed_check.py
// (kernel_raw, pallas_call :96; numpy_ref :20 is the same recurrence). There a
// grid step holds 32 x 128 rows in vector registers and walks the W unit
// columns of its (W, 32, 128) block; here a thread is a row. The block of
// the reference's layout (nB * W, 32, 128) int32 is, with no copy, (nB, W,
// 4096): unit j of row i of block b at [b, j, i], so the threads of a warp
// read neighbouring words of each column.
//
// Per row, for every column j and needle unit k (diag_in = 0 at k = 0):
//   diag = hay == needle[k] ? diag_in + 12 : max(diag_in - 6, 0)
//   cur  = max(diag, max(prev[k] - 1, 0));  best = max(best, cur)
//   diag_in = prev[k];  prev[k] = cur
// The reference also carries a row maximum (srow/left) that never reaches
// the output; it is not computed here.
//
// Bound on this card: operations, 4.5 int32 instructions a cell at the
// fewest (the compare, the miss's relu(diag_in - 6), the match's predicated
// +12, cur as one add-max, half a 3-input max into best) over rows x W x n
// cells, against 4 bytes read a unit and 4 bytes written a row. prev[k],
// best and the needle live in registers (n <= 16); the column loads of a
// row form the only memory traffic.

#include "kernel_common.cuh"

namespace {

constexpr int kBlockRows = 32 * 128;  // rows of one block of the layout
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

}  // namespace

// C entry point (bound with ctypes). cpT (n_blocks * W, 32, 128) int32
// units, scal the (130,) int32 needle scalars ([count, n, orig x 64, flip x
// 64]; the needle is orig[0:n]), out (n_blocks * 32, 128) int32 per-row
// best. 1 <= n <= 16. Returns cudaGetLastError() after the launch.
extern "C" int probe_transposed_launch(const void* cpT, const void* scal, void* out,
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
    launch<N>(c, s, o, rows, W, st); \
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
