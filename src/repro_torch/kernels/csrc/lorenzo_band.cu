// Fused Lorenzo recorrelation + integer stencil planes (2-D, stages 2-4).
//
// Replaces three Pallas sites of repro/kernels/fused.py and the one of
// repro/kernels/prefix_stats.py:
//   lorenzo_enc2d, pass 1 (_colsum_enc_kernel)   -> lorenzo_edges_kernel<true>
//   lorenzo_enc2d, pass 2 (_lorenzo_enc_kernel)  -> lorenzo_stencil_kernel<true>
//   lorenzo2d            (_lorenzo_kernel)       -> lorenzo_stencil_kernel<false>
//                                                   (+ lorenzo_edges_kernel<false>
//                                                   for the band sums the reference
//                                                   takes outside its kernel)
//   prefix_stats.py:prefix_stats2d (_kernel)    -> lorenzo_edges_kernel<false>
//                                                   + prefix_stats_tile_kernel
//                                                   + prefix_stats_reduce_kernel
// With D0 = cumsum(p, 1) and D1 = cumsum(p, 0) (D0 = 0 below the last row, D1 = 0
// right of the last column) the planes are
//   deriv0 = D0[i+1,j] + D0[i,j]       deriv1 = D1[i,j+1] + D1[i,j]
//   lap    = (D0[i+1,j] - D0[i,j]) + (D1[i,j+1] - D1[i,j])
// in int32, wrapping modulo 2^32 like the reference, so any order of
// summation gives the same bits.
//
// Bound on Hopper: memory.  A stencil pass reads the payload (n*bits/8 bytes)
// or the residual plane (4n bytes) once, plus small edge arrays, and writes
// 4 bytes per element per output plane.
// Design: the TPU keeps a whole (r <= 256, n1) band in VMEM; a Hopper block
// has at most 227 KB of shared memory, so the plane is cut into TH x TW tiles
// in both directions and both prefixes are made carry-free between tiles.
// The edge pass emits per-tile row sums and column sums of p; two exclusive
// prefixes over those small arrays (torch ops in the wrapper) give each
// tile's row-prefix edge (sum of p left of the tile) and column-prefix edge
// (sum of p above it).  The stencil pass loads the tile plus one halo row
// and one halo column into shared memory (unpacking payload words inline,
// so the residual plane never exists in device memory on the payload path),
// scans columns and then rows in shared memory starting from the edges, and
// writes the requested planes.  The halo row's and column's edges are read
// from the same edge arrays.  The shared-memory row stride TW+1 is odd, so
// the row-parallel and column-parallel scans are both bank-conflict free.
//
// prefix_stats2d (paper Algorithm 4) gives (sum q, sum q^2) of
// q = cumsum(cumsum(p, 0), 1) without writing q.  The TPU kernel carries the
// previous row of q across a sequential grid; here nothing is carried.  From
// the same edge pass, the row-prefix edge (sum of p left of the tile) and
// the row of q just above the tile (an inclusive cumsum along columns of the
// column-prefix edge, a torch op in the wrapper) are enough to rebuild q in
// each 32 x 128 tile independently: warps scan the tile's rows with
// shuffles starting from the row-prefix edge, then 128 threads scan its
// columns starting from the row above, summing q and q^2 in f64 (exact for
// |q| < 2^26) as they go.  Each tile writes one f64 (sum q, sum q^2) pair; a
// second launch of one block sums the pairs in a fixed order and rounds to
// f32 once.  No atomics: the result is the same bits run after run.
// Bound: memory, p read twice (edge pass and tile pass), 4n bytes each.
#include "common.cuh"

namespace {

constexpr int TH = 32;      // tile rows
constexpr int TW = 128;     // tile columns
constexpr int NT = 256;     // threads per block
constexpr int LD = TW + 1;  // shared-memory row stride (odd)

enum What { DERIV0 = 0, DERIV1 = 1, GRAD = 2, LAP = 3 };

template <bool PAYLOAD>
__global__ void __launch_bounds__(NT)
lorenzo_edges_kernel(const void* __restrict__ src, long long n_words, int bits,
                     int n0, int n1, int n_ct, int32_t* __restrict__ rowsum,
                     int32_t* __restrict__ colsum) {
  __shared__ int32_t P[TH][LD];
  const int tj = blockIdx.x, ti = blockIdx.y;
  const int i0 = ti * TH, j0 = tj * TW;
  for (int e = threadIdx.x; e < TH * TW; e += NT) {
    const int r = e / TW, c = e % TW;
    const int i = i0 + r, j = j0 + c;
    P[r][c] = (i < n0 && j < n1)
                  ? hsz::load_p<PAYLOAD>(src, n_words, bits, (long long)i * n1 + j)
                  : 0;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < TW) {  // column sums of the tile
    const int j = j0 + t;
    uint32_t acc = 0;
    for (int r = 0; r < TH; ++r) acc += (uint32_t)P[r][t];
    if (j < n1) colsum[(long long)ti * n1 + j] = (int32_t)acc;
  } else if (t < TW + TH) {  // row sums of the tile
    const int r = t - TW, i = i0 + r;
    uint32_t acc = 0;
    for (int c = 0; c < TW; ++c) acc += (uint32_t)P[r][c];
    if (i < n0) rowsum[(long long)i * n_ct + tj] = (int32_t)acc;
  }
}

template <bool PAYLOAD>
__global__ void __launch_bounds__(NT)
lorenzo_stencil_kernel(const void* __restrict__ src, long long n_words, int bits,
                       int n0, int n1, int n_ct,
                       const int32_t* __restrict__ rowedge,
                       const int32_t* __restrict__ coledge, int what,
                       int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  __shared__ int32_t A[TH + 1][LD];  // p tile + halo; then D0 in place
  __shared__ int32_t B[TH][LD];      // D1, columns 0..TW
  const int tj = blockIdx.x, ti = blockIdx.y;
  const int i0 = ti * TH, j0 = tj * TW;
  const int t = threadIdx.x;
  for (int e = t; e < (TH + 1) * (TW + 1); e += NT) {
    const int r = e / (TW + 1), c = e % (TW + 1);
    const int i = i0 + r, j = j0 + c;
    A[r][c] = (i < n0 && j < n1)
                  ? hsz::load_p<PAYLOAD>(src, n_words, bits, (long long)i * n1 + j)
                  : 0;
  }
  __syncthreads();
  const bool need0 = what != DERIV1;
  const bool need1 = what != DERIV0;
  // D1: column prefixes from the column-prefix edge (the halo column too);
  // D1 is 0 right of the last column
  if (need1 && t <= TW) {
    const int j = j0 + t;
    uint32_t acc = (j < n1) ? (uint32_t)coledge[(long long)ti * n1 + j] : 0u;
    for (int r = 0; r < TH; ++r) {
      acc += (uint32_t)A[r][t];
      B[r][t] = (j < n1) ? (int32_t)acc : 0;
    }
  }
  __syncthreads();
  // D0: row prefixes in place from the row-prefix edge (the halo row too);
  // D0 is 0 below the last row
  if (need0 && t <= TH) {
    const int i = i0 + t;
    uint32_t acc = (i < n0) ? (uint32_t)rowedge[(long long)i * n_ct + tj] : 0u;
    for (int c = 0; c < TW; ++c) {
      acc += (uint32_t)A[t][c];
      A[t][c] = (i < n0) ? (int32_t)acc : 0;
    }
  }
  __syncthreads();
  for (int e = t; e < TH * TW; e += NT) {
    const int r = e / TW, c = e % TW;
    const int i = i0 + r, j = j0 + c;
    if (i >= n0 || j >= n1) continue;
    const long long k = (long long)i * n1 + j;
    const uint32_t d0 = (uint32_t)A[r][c], d0n = (uint32_t)A[r + 1][c];
    const uint32_t d1 = (uint32_t)B[r][c], d1n = (uint32_t)B[r][c + 1];
    switch (what) {
      case DERIV0: out0[k] = (int32_t)(d0n + d0); break;
      case DERIV1: out0[k] = (int32_t)(d1n + d1); break;
      case GRAD:
        out0[k] = (int32_t)(d0n + d0);
        out1[k] = (int32_t)(d1n + d1);
        break;
      default: out0[k] = (int32_t)((d0n - d0) + (d1n - d1)); break;
    }
  }
}

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// (sum q, sum q^2) of one tile of q = cumsum(cumsum(p, 0), 1).  rowedge as
// for the stencil pass; top[ti, j] = q[ti*TH - 1, j] (0 for the first tile row).
__global__ void __launch_bounds__(NT)
prefix_stats_tile_kernel(const int32_t* __restrict__ p, int n0, int n1, int n_ct,
                         const int32_t* __restrict__ rowedge,
                         const int32_t* __restrict__ top,
                         double* __restrict__ partials) {
  __shared__ int32_t A[TH][LD];
  __shared__ double red[2][NT / 32];
  const int tj = blockIdx.x, ti = blockIdx.y;
  const int i0 = ti * TH, j0 = tj * TW;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int e = t; e < TH * TW; e += NT) {
    const int r = e / TW, c = e % TW;
    const int i = i0 + r, j = j0 + c;
    A[r][c] = (i < n0 && j < n1) ? __ldg(p + (long long)i * n1 + j) : 0;
  }
  __syncthreads();
  // row prefixes (D0) in place, one warp per row, 32 columns per step
  for (int r = warp; r < TH; r += NT / 32) {
    const int i = i0 + r;
    uint32_t carry = (i < n0) ? (uint32_t)rowedge[(long long)i * n_ct + tj] : 0u;
    for (int c0 = 0; c0 < TW; c0 += 32) {
      uint32_t v = (uint32_t)A[r][c0 + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t prev = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += prev;
      }
      A[r][c0 + lane] = (int32_t)(carry + v);
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  // column prefixes from the row of q above the tile, summed as they go
  double s1 = 0.0, s2 = 0.0;
  const int j = j0 + t;
  if (t < TW && j < n1) {
    uint32_t acc = (uint32_t)top[(long long)ti * n1 + j];
    const int rows = min(TH, n0 - i0);
    for (int r = 0; r < rows; ++r) {
      acc += (uint32_t)A[r][t];
      const double qd = (double)(int32_t)acc;
      s1 += qd;
      s2 = fma(qd, qd, s2);
    }
  }
  warp_sum2(s1, s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (t == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < NT / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    const long long tile = (long long)ti * n_ct + tj;
    partials[2 * tile] = a;
    partials[2 * tile + 1] = b;
  }
}

// One block: the tiles' (sum q, sum q^2) pairs summed in a fixed order.
__global__ void __launch_bounds__(NT)
prefix_stats_reduce_kernel(const double* __restrict__ partials, long long n_tiles,
                           float* __restrict__ out) {
  __shared__ double red[2][NT / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double a = 0.0, b = 0.0;
  for (long long k = t; k < n_tiles; k += NT) {
    a += partials[2 * k];
    b += partials[2 * k + 1];
  }
  warp_sum2(a, b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (t == 0) {
    a = 0.0;
    b = 0.0;
    for (int w = 0; w < NT / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    out[0] = __double2float_rn(a);
    out[1] = __double2float_rn(b);
  }
}

}  // namespace

extern "C" int hsz_lorenzo_tile(int* th, int* tw) {
  *th = TH;
  *tw = TW;
  return 0;
}

// rowsum: (n0, ceil(n1/TW)) int32; colsum: (ceil(n0/TH), n1) int32.
extern "C" int hsz_lorenzo_edges(int from_payload, const void* src, long long n_words,
                                 int bits, int n0, int n1, void* rowsum,
                                 void* colsum, void* stream) {
  if (n0 <= 0 || n1 <= 0) return (int)cudaErrorInvalidValue;
  if (from_payload && (bits < 1 || bits > 31)) return (int)cudaErrorInvalidValue;
  const int n_ct = (n1 + TW - 1) / TW, n_rt = (n0 + TH - 1) / TH;
  const dim3 grid(n_ct, n_rt);
  auto s = (cudaStream_t)stream;
  auto rs = static_cast<int32_t*>(rowsum);
  auto cs = static_cast<int32_t*>(colsum);
  if (from_payload)
    lorenzo_edges_kernel<true><<<grid, NT, 0, s>>>(src, n_words, bits, n0, n1, n_ct, rs, cs);
  else
    lorenzo_edges_kernel<false><<<grid, NT, 0, s>>>(src, n_words, bits, n0, n1, n_ct, rs, cs);
  return (int)cudaGetLastError();
}

// rowedge/coledge: exclusive prefixes of rowsum (along tiles) and colsum
// (along tile rows); out0/out1: (n0, n1) int32 (out1 only for what == GRAD).
extern "C" int hsz_lorenzo_stencil(int from_payload, const void* src, long long n_words,
                                   int bits, int n0, int n1, const void* rowedge,
                                   const void* coledge, int what, void* out0,
                                   void* out1, void* stream) {
  if (n0 <= 0 || n1 <= 0 || what < DERIV0 || what > LAP)
    return (int)cudaErrorInvalidValue;
  if (from_payload && (bits < 1 || bits > 31)) return (int)cudaErrorInvalidValue;
  const int n_ct = (n1 + TW - 1) / TW, n_rt = (n0 + TH - 1) / TH;
  const dim3 grid(n_ct, n_rt);
  auto s = (cudaStream_t)stream;
  auto re = static_cast<const int32_t*>(rowedge);
  auto ce = static_cast<const int32_t*>(coledge);
  auto o0 = static_cast<int32_t*>(out0);
  auto o1 = static_cast<int32_t*>(out1);
  if (from_payload)
    lorenzo_stencil_kernel<true><<<grid, NT, 0, s>>>(src, n_words, bits, n0, n1, n_ct,
                                                     re, ce, what, o0, o1);
  else
    lorenzo_stencil_kernel<false><<<grid, NT, 0, s>>>(src, n_words, bits, n0, n1, n_ct,
                                                      re, ce, what, o0, o1);
  return (int)cudaGetLastError();
}

// p: (n0, n1) int32; rowedge: (n0, ceil(n1/TW)) int32; top: (ceil(n0/TH), n1)
// int32; partials: 2 * ceil(n0/TH) * ceil(n1/TW) f64 scratch; out: 2 f32.
// Launches the tile pass and the fixed-order reduction on one stream.
extern "C" int hsz_prefix_stats(const void* p, int n0, int n1, const void* rowedge,
                                const void* top, void* partials, void* out,
                                void* stream) {
  if (n0 <= 0 || n1 <= 0) return (int)cudaErrorInvalidValue;
  const int n_ct = (n1 + TW - 1) / TW, n_rt = (n0 + TH - 1) / TH;
  auto s = (cudaStream_t)stream;
  prefix_stats_tile_kernel<<<dim3(n_ct, n_rt), NT, 0, s>>>(
      static_cast<const int32_t*>(p), n0, n1, n_ct, static_cast<const int32_t*>(rowedge),
      static_cast<const int32_t*>(top), static_cast<double*>(partials));
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  prefix_stats_reduce_kernel<<<1, NT, 0, s>>>(static_cast<const double*>(partials),
                                              (long long)n_ct * n_rt,
                                              static_cast<float*>(out));
  return (int)cudaGetLastError();
}
