// Uniform-width bitplane unpack: 32-bit payload words -> n values.
//
// Replaces the Pallas kernel repro/kernels/bitpack.py:unpack
// (_unpack_kernel), which unpacks through a (V*32, bits) bit-matrix
// contraction sized for the TPU's vector unit.  One template, two
// instantiations:
//   unpack_kernel<false>  the zigzag values as int32 bit patterns (the
//                         Pallas site's counterpart, bitpack.unpack)
//   unpack_kernel<true>   the residuals: unzigzag (ui >> 1) ^ -(ui & 1)
//                         applied in registers (bitpack.unpack_residuals,
//                         the decode of an Encoded field), so no elementwise
//                         torch pass reads and writes the plane again
//
// Bound on Hopper: memory.  The kernel reads n*bits/8 payload bytes and
// writes 4n bytes; it needs a shift and a mask per value (three more to
// unzigzag).  Design:
//  - Chunks.  128 values at width b are exactly 4b words (16b bytes), so
//    every chunk starts on a word and a 16-byte boundary and no value needs
//    a 64-bit bit offset.  A span of SPAN values (SPAN/128 chunks) is
//    SPAN*b/32 words.
//  - Staging.  A block copies a span's words into shared memory with
//    16-byte cp.async (4-byte pieces where the payload pointer is not
//    16-byte aligned or at the end of the payload).
//  - Decode.  Each thread takes 4 consecutive values from a window of the
//    staged words: up to 16 bits one 64-bit window of two funnel shifts,
//    above that one funnel shift each; then writes them with one 16-byte
//    streaming store (st.global.cs), a warp 512 contiguous bytes.  A
//    ragged tail (n % 4 != 0) or an output pointer that is not 16-byte
//    aligned takes masked scalar stores.
//  - Schedule.  A persistent grid (blocks per SM from the occupancy API)
//    walks over the spans and copies the next span's words while it
//    decodes and stores the current one (two buffers).  Held to 32
//    registers, so 8 blocks fit per SM (unbounded it took 48 and fitted
//    5).  On the card this beat one block per span (PERF.md).
//  - Batch.  A batch of B payloads of n_words words each (the fields of a
//    batch_stack view, the counterpart of the reference's vmapped grid)
//    is one launch: the span loop runs over B x n_spans, field b's words
//    start at b * n_words and its values at b * n.  Nothing carries from
//    one span to the next, so no field's words reach another's values.
//    16-byte copies need every field's words 16-byte aligned (n_words % 4
//    == 0 past the first field), 16-byte stores every field's values
//    (n % 4 == 0); a batch without them takes 4-byte pieces.  Spans are
//    counted in 32 bits (at most 2^31 - 1 in a batch) and split into field
//    and span by a magic-number division.
// Widths 0 and 32 are fast paths in the Python wrapper, as in the reference.
#include "common.cuh"

namespace {

constexpr int NT = 256;                   // threads per block
constexpr int STEPS = 2;                  // 4-value groups per thread per span
constexpr int SPAN = NT * 4 * STEPS;      // values per span
constexpr int PAD = 4;                    // words read past a span's last (masked)

static_assert(SPAN % 128 == 0, "a span is whole chunks, so it starts 16-byte aligned");

// Words of one span at `bits`, and the staged buffer's stride.
__host__ __device__ constexpr int span_words(int bits) { return SPAN / 32 * bits; }
__host__ __device__ constexpr int buffer_words(int bits) { return span_words(bits) + PAD; }

// Start copying the words of span s of the batch (span s % n_spans of
// field s / n_spans, its words below n_need) into B.
__device__ __forceinline__ void fetch(const uint32_t* __restrict__ words, long long n_words,
                                      long long n_need, int n_spans, hsz::FastDiv by_spans,
                                      int bits, bool vin, int s, uint32_t* B) {
  const int b = by_spans.div(s);
  const long long w0 = (long long)(s - b * n_spans) * span_words(bits);
  const uint32_t* src = words + b * n_words + w0;
  const int cnt = (int)min((long long)span_words(bits), n_need - w0);
  for (int q = 4 * (int)threadIdx.x; q < cnt; q += 4 * NT) {
    if (vin && q + 3 < cnt) {
      hsz::cp_async16(B + q, src + q);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (q + e < cnt) hsz::cp_async4(B + q + e, src + q + e);
    }
  }
}

// The 4 values at bit offsets off, off + bits, ..., off + 3*bits of the
// staged words w.  Up to 16 bits they lie in 3 words: one 64-bit window of
// two funnel shifts, then a shift and a mask each; above that a funnel
// shift each.
__device__ __forceinline__ void take4(const uint32_t* w, int off, int bits, uint32_t (&u)[4]) {
  const uint32_t mask = (1u << bits) - 1u;
  if (bits <= 16) {
    const int k = off >> 5;
    const uint32_t w0 = w[k], w1 = w[k + 1], w2 = w[k + 2];
    const unsigned long long x =
        ((unsigned long long)__funnelshift_r(w1, w2, off) << 32) | __funnelshift_r(w0, w1, off);
#pragma unroll
    for (int e = 0; e < 4; ++e) u[e] = (uint32_t)(x >> (e * bits)) & mask;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = off + e * bits;
      u[e] = __funnelshift_r(w[o >> 5], w[(o >> 5) + 1], o & 31) & mask;
    }
  }
}

// Value v of span ls of field b at out[b*n + ls*SPAN + v].  Words past a
// span's end (or n_need) hold stale bits; they are only ever shifted into
// bits that the mask drops, since every value below n lies in words below
// n_need.
template <bool UNZIGZAG>
__global__ void __launch_bounds__(NT, 8) unpack_kernel(const uint32_t* __restrict__ words,
                                                    long long n_words, long long n_need,
                                                    uint32_t* __restrict__ out, long long n,
                                                    int bits, int n_spans, int total,
                                                    hsz::FastDiv by_spans, bool vin, bool vout) {
  extern __shared__ __align__(16) uint32_t S[];
  const int bw = buffer_words(bits);
  // the grid has at most one block a span
  fetch(words, n_words, n_need, n_spans, by_spans, bits, vin, blockIdx.x, S);
  hsz::cp_async_commit();
  int buf = 0;
  for (int s = blockIdx.x; s < total; s += gridDim.x, buf ^= 1) {
    hsz::cp_async_wait_all();
    __syncthreads();
    // the next span's copies run under this span's decode and stores
    if (s + (int)gridDim.x < total)
      fetch(words, n_words, n_need, n_spans, by_spans, bits, vin, s + gridDim.x,
            S + (buf ^ 1) * bw);
    hsz::cp_async_commit();
    const uint32_t* B = S + buf * bw;
    const int b = by_spans.div(s);
    const long long g0 = (long long)(s - b * n_spans) * SPAN;
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int v = 4 * (step * NT + (int)threadIdx.x);
      const long long g = g0 + v;
      if (g >= n) break;
      uint32_t u[4];
      take4(B, v * bits, bits, u);
      if constexpr (UNZIGZAG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = (uint32_t)hsz::unzigzag(u[e]);
      }
      hsz::store4(out, (long long)b * n + g, 0, (int)min(n - g, 4LL), vout, u);
    }
  }
}

struct Config {
  cudaError_t err;
  int smem;
  int regs;
  int per_sm;
};

// Shared memory, registers and resident blocks per SM at the largest
// buffers (31 bits), read once; smaller widths use less shared memory, so
// the same grid fits.
template <bool UNZIGZAG>
const Config& config() {
  static const Config c = [] {
    Config k{cudaSuccess, 2 * buffer_words(31) * (int)sizeof(uint32_t), 0, 0};
    cudaFuncAttributes fa;
    k.err = cudaFuncGetAttributes(&fa, unpack_kernel<UNZIGZAG>);
    if (k.err == cudaSuccess) {
      k.regs = fa.numRegs;
      k.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k.per_sm, unpack_kernel<UNZIGZAG>,
                                                            NT, k.smem);
    }
    return k;
  }();
  return c;
}

template <bool UNZIGZAG>
int launch(const uint32_t* words, long long n_words, long long n_need, uint32_t* out,
           long long n, int bits, int batch, cudaStream_t stream) {
  const Config& c = config<UNZIGZAG>();
  if (c.err != cudaSuccess) return (int)c.err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_spans = (n + SPAN - 1) / SPAN, total = n_spans * batch;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)sms * (c.per_sm > 0 ? c.per_sm : 1);
  const long long grid = total < resident ? total : resident;
  const size_t smem = 2 * buffer_words(bits) * sizeof(uint32_t);
  // every field's words and values must be 16-byte aligned, not only the first's
  const bool vin = ((uintptr_t)words & 15u) == 0 && (batch == 1 || (n_words & 3) == 0);
  const bool vout = ((uintptr_t)out & 15u) == 0 && (batch == 1 || (n & 3) == 0);
  unpack_kernel<UNZIGZAG><<<(unsigned)grid, NT, smem, stream>>>(
      words, n_words, n_need, out, n, bits, (int)n_spans, (int)total,
      hsz::FastDiv((uint32_t)n_spans), vin, vout);
  return (int)cudaGetLastError();
}

}  // namespace

// n values at width bits (1..31) from each of `batch` payloads of n_words
// words (field b's at words + b * n_words): zigzag values (unzigzag == 0,
// batch 1 only) or residuals (unzigzag != 0), as int32, into out (field
// b's at out + b * n).
extern "C" int hsz_unpack(const void* words, long long n_words, void* out, long long n, int bits,
                          int unzigzag, int batch, void* stream) {
  if (bits < 1 || bits > 31 || n < 0 || batch < 1 || (!unzigzag && batch != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_need = (n * bits + 31) / 32;
  if (n_need > n_words) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto w = static_cast<const uint32_t*>(words);
  auto o = static_cast<uint32_t*>(out);
  auto s = (cudaStream_t)stream;
  return unzigzag ? launch<true>(w, n_words, n_need, o, n, bits, batch, s)
                  : launch<false>(w, n_words, n_need, o, n, bits, batch, s);
}

// Shared memory at 31 bits (bytes), registers per thread and resident blocks
// per SM of one instantiation.
extern "C" int hsz_unpack_info(int unzigzag, int* smem_bytes, int* regs, int* blocks_per_sm) {
  const Config& c = unzigzag ? config<true>() : config<false>();
  *smem_bytes = c.smem;
  *regs = c.regs;
  *blocks_per_sm = c.per_sm;
  return (int)c.err;
}

namespace hsz {
const KernelInfo unpack_info[] = {
    {"unpack_kernel<false>", (const void*)unpack_kernel<false>, NT,
     2 * buffer_words(31) * (int)sizeof(uint32_t)},
    {"unpack_kernel<true>", (const void*)unpack_kernel<true>, NT,
     2 * buffer_words(31) * (int)sizeof(uint32_t)},
};
const KernelTable unpack_kernels = {unpack_info, 2};
}  // namespace hsz
