// Shared device helpers for the HSZ kernels: the reference's unzigzag,
// asynchronous copies into shared memory, 4 streaming stores.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hsz {

// The reference's unzigzag on the int32 pattern: (ui >> 1) ^ -(ui & 1), with
// an arithmetic shift of the signed value, exactly as encode.unzigzag does.
__device__ __forceinline__ int32_t unzigzag(uint32_t u) {
  const int32_t ui = (int32_t)u;
  return (ui >> 1) ^ -(ui & 1);
}

// Asynchronous copies global -> shared (cp.async): 4 bytes through L1, 16
// bytes around it; a group per commit.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every group / for all but the newest one.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four outputs at flat index k (plane column j), streaming stores; one
// 16-byte store when the row is 16-byte aligned and all four lie in the
// plane (j + 3 < n1).
__device__ __forceinline__ void store4(uint32_t* out, long long k, int j, int n1, bool vec,
                                       const uint32_t (&v)[4]) {
  if (vec && j + 3 < n1) {
    __stcs(reinterpret_cast<uint4*>(out + k), make_uint4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < n1) __stcs(out + k + e, v[e]);
  }
}

// n / d for a divisor d fixed at launch (1 <= d <= 2^31 - 1) and
// 0 <= n < 2^31: a multiply-high, an add and a shift (the Granlund-
// Montgomery magic number, as PyTorch's IntDivider), where a division by a
// runtime value is a long instruction sequence.  Built on the host.
struct FastDiv {
  uint32_t m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t d) : m(0), s(0) {
    while ((1u << s) < d) ++s;
    m = (uint32_t)((((1ull << 32) * ((1ull << s) - d)) / d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

// One kernel instantiation of a source, as hsz_func_attrs reads it: its name
// as kernels/specs.py lists it, the kernel, its threads per block and the
// dynamic shared memory it is launched with (at its largest).
struct KernelInfo {
  const char* name;
  const void* fn;
  int threads;
  int dynamic_smem;
};

struct KernelTable {
  const KernelInfo* info;
  int n;
};

// Every source's instantiations, each defined in its own source (attrs.cu
// concatenates them in the order of specs.KERNEL_IDS).
extern const KernelTable pack_kernels;
extern const KernelTable quant_lorenzo_kernels;
extern const KernelTable block_stats_kernels;
extern const KernelTable stencil_dq_kernels;
extern const KernelTable unpack_kernels;
extern const KernelTable lorenzo_kernels;
extern const KernelTable blockmean_kernels;
extern const KernelTable lorenzo3d_kernels;

}  // namespace hsz
