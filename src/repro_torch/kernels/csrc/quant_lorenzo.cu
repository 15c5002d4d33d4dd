// Fused quantize + 2-D Lorenzo decorrelation: f32 field -> int32 residuals.
//
// Replaces the Pallas kernel repro/kernels/quant_lorenzo.py:quant_lorenzo2d
// (_kernel), which reads the field and three pre-shifted halo views of it.
//   q[i, j] = rint(x[i, j] * inv)          inv = 1 / (2 eps), f32, from the host
//   p[i, j] = q[i, j] - q[i-1, j] - q[i, j-1] + q[i-1, j-1]
// with q = 0 above the first row and left of the first column.  The product
// is __fmul_rn (one IEEE rounding, never contracted) and rintf rounds half to
// even, so q equals torch.round(x * inv) of core/quantize.py bit for bit;
// the Lorenzo sum is uint32, so int32 wrap-around is defined.  `inv` is read
// from device memory (a 0-d f32 tensor computed as core/quantize.py does):
// the kernel never divides, and the host never reads eps.
//
// Bound on Hopper: memory.  The kernel reads x once (4n bytes) and writes p
// once (4n bytes); it does four multiplies and roundings per element.
// Design: one thread per element, a row per blockIdx.y (looping when n0
// exceeds the grid).  Each thread quantizes its own element and its three
// upper/left neighbours again instead of sharing them through shared memory:
// the neighbours' loads are neighbouring words of the current and previous
// row, served from L1/L2, and the recomputation is a few ALU operations.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ uint32_t quant(const float* __restrict__ x, long long k,
                                          float inv) {
  return (uint32_t)(int32_t)rintf(__fmul_rn(__ldg(x + k), inv));
}

__global__ void __launch_bounds__(NT)
quant_lorenzo2d_kernel(const float* __restrict__ x, int n0, int n1,
                       const float* __restrict__ inv_ptr, int32_t* __restrict__ p) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= n1) return;
  const float inv = __ldg(inv_ptr);
  for (int i = blockIdx.y; i < n0; i += gridDim.y) {
    const long long k = (long long)i * n1 + j;
    const uint32_t q = quant(x, k, inv);
    const uint32_t up = i > 0 ? quant(x, k - n1, inv) : 0u;
    const uint32_t left = j > 0 ? quant(x, k - 1, inv) : 0u;
    const uint32_t diag = (i > 0 && j > 0) ? quant(x, k - n1 - 1, inv) : 0u;
    p[k] = (int32_t)(q - up - left + diag);
  }
}

}  // namespace

// x: (n0, n1) f32; inv: one f32 on the device; p: (n0, n1) int32.
extern "C" int hsz_quant_lorenzo2d(const void* x, int n0, int n1, const void* inv,
                                   void* p, void* stream) {
  if (n0 <= 0 || n1 <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n1 + NT - 1) / NT),
                  (unsigned)(n0 < MAX_GRID_Y ? n0 : MAX_GRID_Y));
  quant_lorenzo2d_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), n0, n1, static_cast<const float*>(inv),
      static_cast<int32_t*>(p));
  return (int)cudaGetLastError();
}
