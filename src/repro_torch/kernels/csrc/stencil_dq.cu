// Stage-3 integer stencils on the common interior of a 2-D int32 plane q.
//
// Replaces two Pallas sites of repro/kernels/stencil_dq.py:
//   grad2d      (_grad_kernel) -> grad2d_kernel
//   laplacian2d (_lap_kernel)  -> laplacian2d_kernel
// On the (m0, m1) = (n0 - 2, n1 - 2) interior, with (i, j) the interior
// index and q read at (i + 1 + di, j + 1 + dj):
//   d0  = q[i+2, j+1] - q[i, j+1]          (south - north)
//   d1  = q[i+1, j+2] - q[i+1, j]          (east - west)
//   lap = n + s + w + e - 4 c
// The arithmetic is uint32, so int32 wrap-around is defined and equals the
// reference's modular int32.  The kernels emit exact integer planes only:
// the x eps / x 2eps float tails run in torch outside the kernel, as in the
// reference, so no multiply can be contracted into an FMA.
//
// Bound on Hopper: memory.  grad2d reads q once (4 n0 n1 bytes) and writes
// two interior planes (8 m0 m1 bytes); laplacian2d writes one (4 m0 m1).
// Design: one thread per output element, a row of the interior per
// blockIdx.y (looping when m0 exceeds the grid); the north/south/west/east
// reads of neighbouring threads are neighbouring words, so the repeated
// reads of each q element come from L1/L2 and device memory sees q once.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(NT)
grad2d_kernel(const int32_t* __restrict__ q, int n1, int m0, int m1,
              int32_t* __restrict__ d0, int32_t* __restrict__ d1) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= m1) return;
  for (int i = blockIdx.y; i < m0; i += gridDim.y) {
    const long long c = (long long)(i + 1) * n1 + (j + 1);
    const uint32_t north = (uint32_t)__ldg(q + c - n1);
    const uint32_t south = (uint32_t)__ldg(q + c + n1);
    const uint32_t west = (uint32_t)__ldg(q + c - 1);
    const uint32_t east = (uint32_t)__ldg(q + c + 1);
    const long long o = (long long)i * m1 + j;
    d0[o] = (int32_t)(south - north);
    d1[o] = (int32_t)(east - west);
  }
}

__global__ void __launch_bounds__(NT)
laplacian2d_kernel(const int32_t* __restrict__ q, int n1, int m0, int m1,
                   int32_t* __restrict__ out) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= m1) return;
  for (int i = blockIdx.y; i < m0; i += gridDim.y) {
    const long long c = (long long)(i + 1) * n1 + (j + 1);
    const uint32_t centre = (uint32_t)__ldg(q + c);
    const uint32_t north = (uint32_t)__ldg(q + c - n1);
    const uint32_t south = (uint32_t)__ldg(q + c + n1);
    const uint32_t west = (uint32_t)__ldg(q + c - 1);
    const uint32_t east = (uint32_t)__ldg(q + c + 1);
    out[(long long)i * m1 + j] = (int32_t)(north + south + west + east - 4u * centre);
  }
}

dim3 interior_grid(int m0, int m1) {
  return dim3((unsigned)((m1 + NT - 1) / NT), (unsigned)(m0 < MAX_GRID_Y ? m0 : MAX_GRID_Y));
}

}  // namespace

// q: (n0, n1) int32; d0, d1: (n0 - 2, n1 - 2) int32.  n0, n1 >= 3.
extern "C" int hsz_grad2d(const void* q, int n0, int n1, void* d0, void* d1,
                          void* stream) {
  if (n0 < 3 || n1 < 3) return (int)cudaErrorInvalidValue;
  const int m0 = n0 - 2, m1 = n1 - 2;
  grad2d_kernel<<<interior_grid(m0, m1), NT, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(q), n1, m0, m1, static_cast<int32_t*>(d0),
      static_cast<int32_t*>(d1));
  return (int)cudaGetLastError();
}

// q: (n0, n1) int32; out: (n0 - 2, n1 - 2) int32.  n0, n1 >= 3.
extern "C" int hsz_laplacian2d(const void* q, int n0, int n1, void* out,
                               void* stream) {
  if (n0 < 3 || n1 < 3) return (int)cudaErrorInvalidValue;
  const int m0 = n0 - 2, m1 = n1 - 2;
  laplacian2d_kernel<<<interior_grid(m0, m1), NT, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(q), n1, m0, m1, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

namespace hsz {
const KernelInfo stencil_dq_info[] = {
    {"grad2d_kernel", (const void*)grad2d_kernel, NT, 0},
    {"laplacian2d_kernel", (const void*)laplacian2d_kernel, NT, 0},
};
const KernelTable stencil_dq_kernels = {stencil_dq_info, 2};
}  // namespace hsz
