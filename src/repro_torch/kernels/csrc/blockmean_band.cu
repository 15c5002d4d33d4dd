// Fused block-mean upsample + stencil planes (2-D, stages 2-4).
//
// Replaces two Pallas sites of repro/kernels/fused.py:
//   blockmean_enc2d (_blockmean_enc_kernel) -> blockmean_kernel<true, WHAT>
//   blockmean2d     (_blockmean_kernel)     -> blockmean_kernel<false, WHAT>
// With m the block means upsampled to the plane and every neighbour outside
// the plane read as 0 (for p and for m), the planes are
//   deriv0 = (p_dn - p_up) + (m_dn - m_up)          int32
//   deriv1 = (p_r - p_l) + (m_r - m_l)              int32
//   lap_p  = lap5(p) + lap5(m)                      f32 (stage 2)
//   lap_q  = lap5(p + m)                            f32 (stages 3-4)
// where lap5(x) = (((x_c * -4 + x_dn) + x_up) + x_r) + x_l in f32, the exact
// order of the reference (repro/kernels/fused.py:337-344).  Every float
// operation is an __fmul_rn / __fadd_rn intrinsic, which the compiler never
// contracts into a multiply-add; the eps multiply stays outside the kernel.
// In wrapping int32 arithmetic (p_dn - p_up) + (m_dn - m_up) equals
// q_dn - q_up with q = p + m, so every plane but lap_p needs only q.
//
// Bound on Hopper: bytes, about 90 % of them writes.  The kernel reads the
// payload (n*bits/8 bytes) or the residual plane (4n bytes) and the block
// means (4n/(b0*b1) bytes) once, and writes 4 bytes per element per output
// plane (two planes for grad).  Tensor cores have no part in it: there is
// no product, only an integer stencil and five f32 adds.
//
// Design: a block of 8 warps computes 32 x 128 tiles of outputs.
//  - Tiles in shared memory.  The block stages the (TH+2) x (TW+2)
//    residuals of a tile and its halo once: on the payload path each halo
//    row is one contiguous span of bits whose words a warp copies with
//    coalesced reads, and each lane then unpacks and unzigzags values from
//    shared memory (64-bit bit offsets per row, 32-bit within it, the
//    n_words guard on the copy).  Each residual is unpacked once per tile,
//    not once per neighbour.  Cells outside the plane are written as 0.
//  - No division per element.  Per tile, TH + TW + 4 divisions give the
//    block row of each halo row and the block column of each halo column;
//    the value tile holds q = p + m (p and m apart for lap_p), so tiles need
//    not line up with blocks and any (b0, b1) dividing the plane works.
//  - Wide stores.  A lane computes 4 consecutive outputs of a row from one
//    16-byte shared-memory load per stencil row (left and right neighbours
//    by warp shuffles) and writes them as one 16-byte streaming store
//    (st.global.cs: nothing here reads them again) when rows are 16-byte
//    aligned (n1 % 4 == 0): one warp writes 512 contiguous bytes.  A ragged
//    tile edge or an unaligned row falls back to masked scalar stores.
//  - Loads under stores.  A persistent grid (blocks per SM from the
//    occupancy API) walks over the tiles; each block copies the next tile's
//    words or residuals with cp.async into a second buffer while it expands,
//    computes and stores the current one.  On the card this beat one block
//    per tile with plain loads (PERF.md).
//  - `what` is a template parameter: 5 x 2 instantiations, each doing only
//    its own arithmetic.
#include "common.cuh"

namespace {

constexpr int TH = 32;                 // tile rows (outputs)
constexpr int TW = 128;                // tile columns (outputs)
constexpr int NT = 256;                // threads per block
constexpr int NWARP = NT / 32;
constexpr int ROWS = TH / NWARP;       // output rows per warp
constexpr int HR = TH + 2;             // halo rows
constexpr int HC = TW + 2;             // halo columns
// Shared-memory row stride in words: halo column c sits at c + 3, so the
// interior starts at word 4 and every lane's 4 outputs are 16-byte aligned.
// A payload row of HC values at <= 31 bits spans <= 127 words (+1 sentinel).
constexpr int LD = TW + 8;
constexpr int TILE = HR * LD;          // words per staged tile
constexpr unsigned FULL = 0xffffffffu;

static_assert(TH % NWARP == 0 && TW == 4 * 32, "one warp covers a tile row");
static_assert(LD >= 128, "a payload row needs 127 words and a sentinel");

enum What { DERIV0 = 0, DERIV1 = 1, GRAD = 2, LAP_P = 3, LAP_Q = 4 };

struct Args {
  const void* src;        // payload words or the int32 residual plane
  long long n_words;      // payload words (payload path)
  int bits;               // payload width 1..31 (payload path)
  int n0, n1;             // plane
  const int32_t* meta;    // (n0/b0, ng1) block means
  int ng1, b0, b1;
  uint32_t* out0;
  uint32_t* out1;         // grad only
  int n_ct, n_tiles;      // tile columns, tiles
};

__device__ __forceinline__ float lap5(uint32_t c, uint32_t dn, uint32_t up,
                                      uint32_t right, uint32_t left) {
  float acc = __fmul_rn(__int2float_rn((int32_t)c), -4.0f);
  acc = __fadd_rn(acc, __int2float_rn((int32_t)dn));
  acc = __fadd_rn(acc, __int2float_rn((int32_t)up));
  acc = __fadd_rn(acc, __int2float_rn((int32_t)right));
  acc = __fadd_rn(acc, __int2float_rn((int32_t)left));
  return acc;
}

using hsz::cp_async4;
using hsz::cp_async_commit;
using hsz::cp_async_wait_prev;
using hsz::store4;

// Payload bits of halo row i (in the plane) of the tile at column j0: its
// first plane column, its first bit and the words it touches.
struct RowSpan {
  int jlo;
  unsigned long long bit0;
  int n_words;
};

__device__ __forceinline__ RowSpan row_span(int i, int j0, int n1, int bits) {
  const int jlo = max(j0 - 1, 0), jhi = min(j0 + TW, n1 - 1);
  const unsigned long long k = (unsigned long long)i * (unsigned)n1;
  const unsigned long long first = (k + jlo) * (unsigned)bits;
  const unsigned long long end = (k + jhi + 1) * (unsigned)bits;
  return {jlo, first, (int)(((end - 1) >> 5) - (first >> 5)) + 1};
}

// First output row and column of a tile (row-major over the tile grid).
__device__ __forceinline__ void tile_origin(const Args& a, int tile, int& i0, int& j0) {
  const int ti = tile / a.n_ct;
  i0 = ti * TH;
  j0 = (tile - ti * a.n_ct) * TW;
}

// Start copying the raw input of a tile into R with cp.async: per halo row
// in the plane, the payload words of its span followed by a 0 sentinel, or
// its residuals at word c + 3 for halo column c (0 outside the plane).  Warp
// w takes halo rows w, w + 8, ...; rows outside the plane are left alone.
template <bool PAYLOAD>
__device__ __forceinline__ void fetch(const Args& a, int tile, uint32_t* R) {
  int i0, j0;
  tile_origin(a, tile, i0, j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < HR; r += NWARP) {
    const int i = i0 - 1 + r;
    if (i < 0 || i >= a.n0) continue;
    uint32_t* row = R + r * LD;
    if constexpr (PAYLOAD) {
      const auto* words = static_cast<const uint32_t*>(a.src);
      const RowSpan sp = row_span(i, j0, a.n1, a.bits);
      const long long w0 = (long long)(sp.bit0 >> 5);
      for (int q = lane; q <= sp.n_words; q += 32) {
        if (q < sp.n_words && w0 + q < a.n_words) cp_async4(row + q, words + w0 + q);
        else row[q] = 0u;
      }
    } else {
      const auto* p = static_cast<const uint32_t*>(a.src) + (long long)i * a.n1;
      for (int c = lane; c < HC; c += 32) {
        const int j = j0 - 1 + c;
        if (j >= 0 && j < a.n1) cp_async4(row + 3 + c, p + j);
        else row[3 + c] = 0u;
      }
    }
  }
}

// Block column of each halo column and flat offset of the block row of each
// halo row in the block means (-1 outside the plane): the tile's only
// divisions.
__device__ __forceinline__ void tile_index(const Args& a, int i0, int j0, int* colb,
                                           int* rowoff) {
  const int t = threadIdx.x;
  if (t < HC) {
    const int j = j0 - 1 + t;
    colb[t] = (j >= 0 && j < a.n1) ? j / a.b1 : -1;
  } else if (t < HC + HR) {
    const int r = t - HC, i = i0 - 1 + r;
    rowoff[r] = (i >= 0 && i < a.n0) ? (i / a.b0) * a.ng1 : -1;
  }
}

// From the raw tile R, write S = p + m (lap_p: S = p and M = m) at word
// c + 3 of each halo row, 0 outside the plane.
template <bool PAYLOAD, int WHAT>
__device__ __forceinline__ void expand(const Args& a, int i0, int j0, const uint32_t* R,
                                       const int* colb, const int* rowoff, uint32_t* S,
                                       uint32_t* M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < HR; r += NWARP) {
    const int ro = rowoff[r];
    const uint32_t* row = R + r * LD;
    // bit offset of halo column c within the staged words: c * bits + base
    int base = 0;
    if constexpr (PAYLOAD) {
      if (ro >= 0) {
        const RowSpan sp = row_span(i0 - 1 + r, j0, a.n1, a.bits);
        base = (int)(sp.bit0 & 31ull) + (j0 - 1 - sp.jlo) * a.bits;
      }
    }
#pragma unroll
    for (int c0 = 0; c0 < HC; c0 += 32) {
      const int c = c0 + lane;
      if (c >= HC) break;
      const int cb = colb[c];
      uint32_t p = 0u, m = 0u;
      if (ro >= 0 && cb >= 0) {
        if constexpr (PAYLOAD) {
          const int off = c * a.bits + base;
          const uint32_t u = __funnelshift_r(row[off >> 5], row[(off >> 5) + 1], off & 31);
          p = (uint32_t)hsz::unzigzag(u & ((1u << a.bits) - 1u));
        } else {
          p = row[3 + c];
        }
        m = (uint32_t)__ldg(a.meta + ro + cb);
      }
      if constexpr (WHAT == LAP_P) {
        S[r * LD + 3 + c] = p;
        M[r * LD + 3 + c] = m;
      } else {
        S[r * LD + 3 + c] = p + m;
      }
    }
  }
}

// Halo row r of tile T at the lane's 4 interior columns: x[1..4]; with LR
// also the left and right neighbours x[0] and x[5] (shuffled from the
// neighbouring lanes, the halo columns for lanes 0 and 31).
template <bool LR>
__device__ __forceinline__ void load_row(const uint32_t* T, int r, int lane,
                                         uint32_t (&x)[6]) {
  const uint4 v = *reinterpret_cast<const uint4*>(T + r * LD + 4 + 4 * lane);
  x[1] = v.x;
  x[2] = v.y;
  x[3] = v.z;
  x[4] = v.w;
  if constexpr (LR) {
    const uint32_t l = __shfl_up_sync(FULL, v.w, 1);
    const uint32_t rr = __shfl_down_sync(FULL, v.x, 1);
    x[0] = lane == 0 ? T[r * LD + 3] : l;
    x[5] = lane == 31 ? T[r * LD + 4 + TW] : rr;
  }
}

// The requested planes of the tile at (i0, j0) from S (and M): warp w writes
// output rows w*ROWS .. w*ROWS + ROWS-1, lane l columns 4l .. 4l+3.
template <int WHAT>
__device__ __forceinline__ void compute_store(const Args& a, int i0, int j0,
                                              const uint32_t* S, const uint32_t* M) {
  constexpr bool LR = WHAT != DERIV0;  // needs left / right neighbours
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * ROWS;  // halo row above the warp's first output row
  const int j = j0 + 4 * lane;
  const bool vec = (a.n1 & 3) == 0;
  uint32_t up[6] = {}, ce[6] = {}, dn[6] = {};
  uint32_t mu[6] = {}, mc[6] = {}, md[6] = {};
  load_row<LR>(S, r0, lane, up);
  load_row<LR>(S, r0 + 1, lane, ce);
  if constexpr (WHAT == LAP_P) {
    load_row<true>(M, r0, lane, mu);
    load_row<true>(M, r0 + 1, lane, mc);
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    load_row<LR>(S, r0 + k + 2, lane, dn);
    if constexpr (WHAT == LAP_P) load_row<true>(M, r0 + k + 2, lane, md);
    uint32_t o0[4], o1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t d0 = dn[e + 1] - up[e + 1];
      const uint32_t d1 = ce[e + 2] - ce[e];
      if constexpr (WHAT == DERIV0) o0[e] = d0;
      if constexpr (WHAT == DERIV1) o0[e] = d1;
      if constexpr (WHAT == GRAD) {
        o0[e] = d0;
        o1[e] = d1;
      }
      if constexpr (WHAT == LAP_Q)
        o0[e] = __float_as_uint(lap5(ce[e + 1], dn[e + 1], up[e + 1], ce[e + 2], ce[e]));
      if constexpr (WHAT == LAP_P)
        o0[e] = __float_as_uint(
            __fadd_rn(lap5(ce[e + 1], dn[e + 1], up[e + 1], ce[e + 2], ce[e]),
                      lap5(mc[e + 1], md[e + 1], mu[e + 1], mc[e + 2], mc[e])));
    }
    const int i = i0 + r0 + k;
    if (i < a.n0) {
      const long long kk = (long long)i * a.n1 + j;
      store4(a.out0, kk, j, a.n1, vec, o0);
      if constexpr (WHAT == GRAD) store4(a.out1, kk, j, a.n1, vec, o1);
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      up[e] = ce[e];
      ce[e] = dn[e];
      if constexpr (WHAT == LAP_P) {
        mu[e] = mc[e];
        mc[e] = md[e];
      }
    }
  }
}

// Shared memory: S, then M (lap_p only), then two raw tiles, then the
// per-tile block indices.
constexpr int smem_bytes(int what) {
  return 4 * (TILE * ((what == LAP_P ? 2 : 1) + 2) + HC + HR);
}

template <bool PAYLOAD, int WHAT>
__global__ void __launch_bounds__(NT) blockmean_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* S = smem;
  uint32_t* M = smem + TILE;  // lap_p only
  uint32_t* R = smem + TILE * (WHAT == LAP_P ? 2 : 1);
  int* colb = reinterpret_cast<int*>(R + 2 * TILE);
  int* rowoff = colb + HC;
  fetch<PAYLOAD>(a, blockIdx.x, R);  // the grid has at most one block a tile
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, buf ^= 1) {
    // the next tile's copies go out before this tile's have to land
    const int next = tile + gridDim.x;
    if (next < a.n_tiles) fetch<PAYLOAD>(a, next, R + (buf ^ 1) * TILE);
    cp_async_commit();
    cp_async_wait_prev();
    int i0, j0;
    tile_origin(a, tile, i0, j0);
    tile_index(a, i0, j0, colb, rowoff);
    __syncthreads();
    expand<PAYLOAD, WHAT>(a, i0, j0, R + buf * TILE, colb, rowoff, S, M);
    __syncthreads();
    compute_store<WHAT>(a, i0, j0, S, M);
  }
}

// Dynamic shared memory and resident blocks per SM of one instantiation,
// set up once (above 48 KB a block's shared memory must be allowed first).
struct Config {
  cudaError_t err;
  int smem;
  int per_sm;
};

template <bool PAYLOAD, int WHAT>
const Config& config() {
  static const Config c = [] {
    auto kernel = blockmean_kernel<PAYLOAD, WHAT>;
    Config k{cudaSuccess, smem_bytes(WHAT), 0};
    k.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 k.smem);
    if (k.err == cudaSuccess)
      k.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k.per_sm, kernel, NT, k.smem);
    return k;
  }();
  return c;
}

// A persistent grid: as many blocks as can be resident, at most one a tile.
template <bool PAYLOAD, int WHAT>
int launch(const Args& a, cudaStream_t stream) {
  const Config& c = config<PAYLOAD, WHAT>();
  if (c.err != cudaSuccess) return (int)c.err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(a.n_tiles, sms * max(c.per_sm, 1));
  blockmean_kernel<PAYLOAD, WHAT><<<grid, NT, c.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAYLOAD>
int dispatch(const Args& a, int what, cudaStream_t s) {
  switch (what) {
    case DERIV0: return launch<PAYLOAD, DERIV0>(a, s);
    case DERIV1: return launch<PAYLOAD, DERIV1>(a, s);
    case GRAD: return launch<PAYLOAD, GRAD>(a, s);
    case LAP_P: return launch<PAYLOAD, LAP_P>(a, s);
    default: return launch<PAYLOAD, LAP_Q>(a, s);
  }
}

template <bool PAYLOAD>
const Config& config_of(int what) {
  switch (what) {
    case DERIV0: return config<PAYLOAD, DERIV0>();
    case DERIV1: return config<PAYLOAD, DERIV1>();
    case GRAD: return config<PAYLOAD, GRAD>();
    case LAP_P: return config<PAYLOAD, LAP_P>();
    default: return config<PAYLOAD, LAP_Q>();
  }
}

}  // namespace

// meta: (n0/b0, n1/b1) int32 block means; out0/out1: (n0, n1), int32 for the
// derivative planes, f32 for lap_p / lap_q (out1 only for what == GRAD).
extern "C" int hsz_blockmean(int from_payload, const void* src, long long n_words,
                             int bits, int n0, int n1, const void* meta, int b0,
                             int b1, int what, void* out0, void* out1, void* stream) {
  if (n0 <= 0 || n1 <= 0 || b0 <= 0 || b1 <= 0 || n0 % b0 || n1 % b1 ||
      what < DERIV0 || what > LAP_Q)
    return (int)cudaErrorInvalidValue;
  if (from_payload && (bits < 1 || bits > 31)) return (int)cudaErrorInvalidValue;
  const int n_ct = (n1 + TW - 1) / TW, n_rt = (n0 + TH - 1) / TH;
  const Args a{src, n_words, from_payload ? bits : 1, n0, n1,
               static_cast<const int32_t*>(meta), n1 / b1, b0, b1,
               static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
               n_ct, n_ct * n_rt};
  auto s = (cudaStream_t)stream;
  return from_payload ? dispatch<true>(a, what, s) : dispatch<false>(a, what, s);
}

// Dynamic shared memory (bytes) and resident blocks per SM of the kernel
// that hsz_blockmean launches for (from_payload, what).
extern "C" int hsz_blockmean_info(int from_payload, int what, int* smem_bytes,
                                  int* blocks_per_sm) {
  if (what < DERIV0 || what > LAP_Q) return (int)cudaErrorInvalidValue;
  const Config& c = from_payload ? config_of<true>(what) : config_of<false>(what);
  *smem_bytes = c.smem;
  *blocks_per_sm = c.per_sm;
  return (int)c.err;
}
