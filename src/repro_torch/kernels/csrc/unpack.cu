// Uniform-width bitplane unpack: 32-bit payload words -> n zigzag values.
//
// Replaces the Pallas kernel repro/kernels/bitpack.py:unpack
// (_unpack_kernel), which unpacks through a (V*32, bits) bit-matrix
// contraction sized for the TPU's vector unit.
//
// Bound on Hopper: memory.  The kernel reads n*bits/8 payload bytes and
// writes 4n bytes; its arithmetic is a few integer operations per value.
// Design: one thread per output value.  Value i sits at bit offset i*bits
// (64-bit, no wrap); the thread reads the two words that offset can touch as
// one 64-bit window, shifts and masks.  Neighbouring threads read
// neighbouring words (served from L1/L2 after the first touch) and write
// neighbouring int32s, so both streams are coalesced.  Widths 0 and 32 are
// fast paths in the Python wrapper, as in the reference; the zigzag values
// are written as int32 bit patterns and unzigzag runs in torch afterwards.
#include "common.cuh"

namespace {

__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              long long n_words, int32_t* __restrict__ out,
                              long long n, int bits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (int32_t)hsz::unpack_one(words, n_words, i, bits);
  }
}

}  // namespace

extern "C" int hsz_unpack(const void* words, long long n_words, void* out,
                          long long n, int bits, void* stream) {
  if (bits < 1 || bits > 31 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  unpack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<int32_t*>(out),
      n, bits);
  return (int)cudaGetLastError();
}
