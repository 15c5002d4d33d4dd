// Per-block metadata reduction: rounded integer mean and zigzag max.
//
// Replaces the Pallas kernel repro/kernels/block_stats.py:block_stats
// (_kernel).  For each row of an (n_blocks, S) int32 matrix:
//   s    = sum(q)                           int32, modular
//   mean = floor((2 s + S) / (2 S))         int32 (2 s + S wraps like int32)
//   maxu = max((q << 1) ^ (q >> 31))        unsigned compare
// The division FLOORS: C's `/` truncates toward zero, so a negative
// numerator with a remainder is stepped down by one (the parity trap pinned
// by tests/test_kernels.py::test_block_stats_signed_parity_with_core).  maxu
// is written as the int32 bit pattern of the uint32 value, the port's
// convention for 32-bit words (core/encode.py).
//
// Bound on Hopper: memory.  The kernel reads the matrix once (4 n_blocks S
// bytes) and writes 8 bytes per row.
// Design: one warp per row, eight rows per 256-thread block.  Lane l sums
// and maxes elements l, l + 32, ... of its row (each step of the warp reads
// 128 contiguous bytes), then five shuffle steps combine the lanes; lane 0
// applies the floor division and writes both results.  Integer sums and
// maxima are exact in any order, so the result is deterministic.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;

__global__ void __launch_bounds__(NT)
block_stats_kernel(const int32_t* __restrict__ q, long long n_blocks, int s_len,
                   int32_t* __restrict__ means, int32_t* __restrict__ maxu) {
  const int lane = threadIdx.x & 31;
  const long long warps_total = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       row < n_blocks; row += warps_total) {
    const int32_t* r = q + row * s_len;
    uint32_t sum = 0, mx = 0;
    for (int k = lane; k < s_len; k += 32) {
      const int32_t v = __ldg(r + k);
      sum += (uint32_t)v;
      const uint32_t z = ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
      mx = z > mx ? z : mx;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mx, off);
      mx = other > mx ? other : mx;
    }
    if (lane == 0) {
      const int32_t num = (int32_t)(2u * sum + (uint32_t)s_len);
      const int32_t den = 2 * s_len;
      int32_t m = num / den;
      if (num % den != 0 && num < 0) m -= 1;  // floor, not truncation
      means[row] = m;
      maxu[row] = (int32_t)mx;
    }
  }
}

}  // namespace

// q: (n_blocks, s_len) int32; means, maxu: (n_blocks,) int32.
extern "C" int hsz_block_stats(const void* q, long long n_blocks, int s_len,
                               void* means, void* maxu, void* stream) {
  if (n_blocks < 0 || s_len < 1 || s_len > (1 << 29)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  long long blocks = (n_blocks + WARPS - 1) / WARPS;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  block_stats_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(q), n_blocks, s_len, static_cast<int32_t*>(means),
      static_cast<int32_t*>(maxu));
  return (int)cudaGetLastError();
}

namespace hsz {
const KernelInfo block_stats_info[] = {
    {"block_stats_kernel", (const void*)block_stats_kernel, NT, 0},
};
const KernelTable block_stats_kernels = {block_stats_info, 1};
}  // namespace hsz
