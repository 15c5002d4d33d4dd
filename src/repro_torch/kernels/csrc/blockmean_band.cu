// Fused block-mean upsample + stencil planes (2-D, stages 2-4).
//
// Replaces two Pallas sites of repro/kernels/fused.py:
//   blockmean_enc2d (_blockmean_enc_kernel) -> blockmean_kernel<true>
//   blockmean2d     (_blockmean_kernel)     -> blockmean_kernel<false>
// With m the block means upsampled to the plane and every neighbour outside
// the plane read as 0, the planes are
//   deriv0 = (p_dn - p_up) + (m_dn - m_up)          int32
//   deriv1 = (p_r - p_l) + (m_r - m_l)              int32
//   lap_p  = lap5(p) + lap5(m)                      f32 (stage 2)
//   lap_q  = lap5(p + m)                            f32 (stages 3-4)
// where lap5(x) = (((x_c * -4 + x_dn) + x_up) + x_r) + x_l in f32, the exact
// order of the reference (repro/kernels/fused.py:337-344).  Every float
// operation is an __fmul_rn / __fadd_rn intrinsic, which the compiler never
// contracts into a multiply-add; the eps multiply stays outside the kernel.
//
// Bound on Hopper: memory.  The kernel reads the payload (n*bits/8 bytes) or
// the residual plane (4n bytes) and the block means (4n/(b0*b1) bytes) once,
// and writes 4 bytes per element per output plane.
// Design: one thread per output element, 32 x 8 threads per block; each
// thread reads p at its five stencil points (unpacking payload words inline,
// so the residual plane never exists in device memory on the payload path)
// and m = meta[i/b0, j/b1] at the same points.  Neighbouring threads touch
// neighbouring words, so the repeated reads are served from L1/L2.
#include "common.cuh"

namespace {

enum What { DERIV0 = 0, DERIV1 = 1, GRAD = 2, LAP_P = 3, LAP_Q = 4 };

__device__ __forceinline__ float lap5(int32_t c, int32_t dn, int32_t up,
                                      int32_t right, int32_t left) {
  float acc = __fmul_rn(__int2float_rn(c), -4.0f);
  acc = __fadd_rn(acc, __int2float_rn(dn));
  acc = __fadd_rn(acc, __int2float_rn(up));
  acc = __fadd_rn(acc, __int2float_rn(right));
  acc = __fadd_rn(acc, __int2float_rn(left));
  return acc;
}

template <bool PAYLOAD>
__global__ void blockmean_kernel(const void* __restrict__ src, long long n_words,
                                 int bits, int n0, int n1,
                                 const int32_t* __restrict__ meta, int ng1, int b0,
                                 int b1, int what, void* __restrict__ out0,
                                 void* __restrict__ out1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n0 || j >= n1) return;
  auto P = [&](int ii, int jj) -> uint32_t {
    if (ii < 0 || ii >= n0 || jj < 0 || jj >= n1) return 0u;
    return (uint32_t)hsz::load_p<PAYLOAD>(src, n_words, bits, (long long)ii * n1 + jj);
  };
  auto M = [&](int ii, int jj) -> uint32_t {
    if (ii < 0 || ii >= n0 || jj < 0 || jj >= n1) return 0u;
    return (uint32_t)__ldg(meta + (long long)(ii / b0) * ng1 + jj / b1);
  };
  const long long k = (long long)i * n1 + j;
  int32_t* o0 = static_cast<int32_t*>(out0);
  int32_t* o1 = static_cast<int32_t*>(out1);
  if (what == DERIV0 || what == GRAD) {
    o0[k] = (int32_t)((P(i + 1, j) - P(i - 1, j)) + (M(i + 1, j) - M(i - 1, j)));
  }
  if (what == DERIV1 || what == GRAD) {
    int32_t* o = (what == GRAD) ? o1 : o0;
    o[k] = (int32_t)((P(i, j + 1) - P(i, j - 1)) + (M(i, j + 1) - M(i, j - 1)));
  }
  if (what == LAP_P || what == LAP_Q) {
    const uint32_t pc = P(i, j), pd = P(i + 1, j), pu = P(i - 1, j);
    const uint32_t pr = P(i, j + 1), pl = P(i, j - 1);
    const uint32_t mc = M(i, j), md = M(i + 1, j), mu = M(i - 1, j);
    const uint32_t mr = M(i, j + 1), ml = M(i, j - 1);
    float v;
    if (what == LAP_P) {
      v = __fadd_rn(lap5((int32_t)pc, (int32_t)pd, (int32_t)pu, (int32_t)pr, (int32_t)pl),
                    lap5((int32_t)mc, (int32_t)md, (int32_t)mu, (int32_t)mr, (int32_t)ml));
    } else {
      v = lap5((int32_t)(pc + mc), (int32_t)(pd + md), (int32_t)(pu + mu),
               (int32_t)(pr + mr), (int32_t)(pl + ml));
    }
    static_cast<float*>(out0)[k] = v;
  }
}

}  // namespace

// meta: (n0/b0, ng1) int32 block means; out0/out1: (n0, n1), int32 for the
// derivative planes, f32 for lap_p / lap_q (out1 only for what == GRAD).
extern "C" int hsz_blockmean(int from_payload, const void* src, long long n_words,
                             int bits, int n0, int n1, const void* meta, int b0,
                             int b1, int what, void* out0, void* out1, void* stream) {
  if (n0 <= 0 || n1 <= 0 || b0 <= 0 || b1 <= 0 || n0 % b0 || n1 % b1 ||
      what < DERIV0 || what > LAP_Q)
    return (int)cudaErrorInvalidValue;
  if (from_payload && (bits < 1 || bits > 31)) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((n1 + 31) / 32, (n0 + 7) / 8);
  auto s = (cudaStream_t)stream;
  auto m = static_cast<const int32_t*>(meta);
  const int ng1 = n1 / b1;
  if (from_payload)
    blockmean_kernel<true><<<grid, block, 0, s>>>(src, n_words, bits, n0, n1, m, ng1,
                                                  b0, b1, what, out0, out1);
  else
    blockmean_kernel<false><<<grid, block, 0, s>>>(src, n_words, bits, n0, n1, m, ng1,
                                                   b0, b1, what, out0, out1);
  return (int)cudaGetLastError();
}
