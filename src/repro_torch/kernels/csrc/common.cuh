// Shared device helpers for the HSZ kernels: reading one residual either
// from the bit-packed payload (uniform width `bits`, 1..31) or from a
// decoded int32 residual plane.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hsz {

// Zigzag value `i` of a uniform-width stream, read as one 64-bit window of
// the two words its bits can touch.  The bit offset is computed in 64 bits,
// so it never wraps (the reference's uint32 offsets wrap at n*bits >= 2^32).
__device__ __forceinline__ uint32_t unpack_one(const uint32_t* __restrict__ words,
                                               long long n_words, long long i,
                                               int bits) {
  const unsigned long long off = (unsigned long long)i * (unsigned)bits;
  const long long w = (long long)(off >> 5);
  const unsigned s = (unsigned)(off & 31ull);
  const unsigned long long lo = __ldg(words + w);
  const unsigned long long hi = (w + 1 < n_words) ? __ldg(words + w + 1) : 0ull;
  const uint32_t mask = (1u << bits) - 1u;
  return (uint32_t)(((hi << 32) | lo) >> s) & mask;
}

// The reference's unzigzag on the int32 pattern: (ui >> 1) ^ -(ui & 1), with
// an arithmetic shift of the signed value, exactly as encode.unzigzag does.
__device__ __forceinline__ int32_t unzigzag(uint32_t u) {
  const int32_t ui = (int32_t)u;
  return (ui >> 1) ^ -(ui & 1);
}

// Residual at flat index k: unpacked from payload words (PAYLOAD) or read
// from the int32 residual plane.
template <bool PAYLOAD>
__device__ __forceinline__ int32_t load_p(const void* __restrict__ src,
                                          long long n_words, int bits,
                                          long long k) {
  if constexpr (PAYLOAD) {
    return unzigzag(unpack_one(static_cast<const uint32_t*>(src), n_words, k, bits));
  } else {
    return __ldg(static_cast<const int32_t*>(src) + k);
  }
}

}  // namespace hsz
