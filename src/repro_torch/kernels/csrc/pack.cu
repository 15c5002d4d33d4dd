// Uniform-width bitplane pack: n zigzag values -> ceil(n*bits/32) words.
//
// Replaces the Pallas kernel repro/kernels/bitpack.py:pack (_pack_kernel),
// which packs through a (V, bits) bit matrix reshaped to (V*bits/32, 32)
// rows, a layout sized for the TPU's vector unit.  The words equal
// core/encode.py:pack_uniform word for word: value i, masked to its low
// `bits` bits, lands at bit offset i*bits of the little-endian word stream.
//
// Bound on Hopper: memory.  The kernel reads the values once (4n bytes) and
// writes the words once (n*bits/8 bytes).
// Design: one thread per output word, no atomics, so the result is the same
// bits on every run.  Word w covers stream bits [32w, 32w + 32); the values
// that overlap it are i = floor(32w / bits) .. floor((32w + 31) / bits),
// at most ceil(32 / bits) + 1 of them, read with 64-bit bit offsets (no
// wrap at n*bits >= 2^32).  Each value is masked to `bits` and shifted into
// place (right for the one that starts in the previous word), and the
// thread ORs them.  Neighbouring threads read neighbouring runs of values,
// so the reads coalesce through L1.  Widths 0 and 32 are fast paths in the
// Python wrapper, as in the reference.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block

__global__ void pack_kernel(const uint32_t* __restrict__ u, long long n,
                            uint32_t* __restrict__ words, long long n_words, int bits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint32_t mask = (1u << bits) - 1u;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < n_words;
       w += stride) {
    const long long lo_bit = w * 32;
    long long last = (lo_bit + 31) / bits;
    if (last > n - 1) last = n - 1;
    uint32_t acc = 0;
    for (long long i = lo_bit / bits; i <= last; ++i) {
      const uint32_t v = __ldg(u + i) & mask;
      const long long s = i * bits - lo_bit;  // -31 < s < 32
      acc |= s >= 0 ? (v << s) : (v >> -s);
    }
    words[w] = acc;
  }
}

}  // namespace

// u: (n,) int32 zigzag values; words: (n_words,) int32, n_words =
// ceil(n * bits / 32).  bits in 1..31.
extern "C" int hsz_pack(const void* u, long long n, void* words, long long n_words,
                        int bits, void* stream) {
  if (bits < 1 || bits > 31 || n < 0 || n_words != (n * bits + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (n_words == 0) return 0;
  long long blocks = (n_words + NT - 1) / NT;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  pack_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(u), n, static_cast<uint32_t*>(words), n_words, bits);
  return (int)cudaGetLastError();
}

namespace hsz {
const KernelInfo pack_info[] = {
    {"pack_kernel", (const void*)pack_kernel, NT, 0},
};
const KernelTable pack_kernels = {pack_info, 1};
}  // namespace hsz
