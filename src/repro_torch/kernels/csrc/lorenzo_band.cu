// Fused Lorenzo recorrelation + integer stencil planes (2-D, stages 2-4).
//
// Replaces three Pallas sites of repro/kernels/fused.py and the one of
// repro/kernels/prefix_stats.py:
//   lorenzo_enc2d, pass 1 (_colsum_enc_kernel)   -> lorenzo_edges_kernel<true>
//   lorenzo_enc2d, pass 2 (_lorenzo_enc_kernel)  -> lorenzo_stencil_kernel<true, WHAT>
//   lorenzo2d            (_lorenzo_kernel)       -> lorenzo_stencil_kernel<false, WHAT>
//                                                   (+ lorenzo_edges_kernel<false>
//                                                   for the band sums the reference
//                                                   takes outside its kernel)
//   prefix_stats.py:prefix_stats2d (_kernel)    -> lorenzo_edges_kernel<false>
//                                                   + corner_scan_kernel
//                                                   + prefix_stats_tile_kernel<WIDE>
//                                                   + prefix_stats_reduce_kernel
// With D0 = cumsum(p, 1) and D1 = cumsum(p, 0) (D0 = 0 below the last row, D1 = 0
// right of the last column) the planes are
//   deriv0 = D0[i+1,j] + D0[i,j]       deriv1 = D1[i,j+1] + D1[i,j]
//   lap    = (D0[i+1,j] - D0[i,j]) + (D1[i,j+1] - D1[i,j])
// in int32, wrapping modulo 2^32 like the reference, so any order of
// summation gives the same bits.
//
// Tiling.  The TPU keeps a whole (r <= 256, n1) band in VMEM and carries the
// row prefix across a sequential grid; Hopper blocks run in no order, so the
// plane is cut into 32 x 128 tiles and both prefixes are made carry-free
// between tiles by two edge arrays: rowedge[i, tj] = sum of p left of tile
// column tj in row i, coledge[ti, j] = sum of p above tile row ti in column j.
//
//  - The edge pass reads each tile once and writes its per-row sums into
//    rowedge and its per-column sums into coledge; a second small kernel
//    (lorenzo_scan_kernel) turns them into exclusive prefixes in place: a
//    warp per row of rowedge, and per 32 columns of coledge 8 warps that
//    each sum one segment of tile rows, meet in shared memory and write
//    their segment's prefixes.  No torch op and no host work sits between
//    the three kernels of a query.  (Letting the last tile of each tile
//    row and column do the scans inside the edge kernel, after an arrival
//    counter, was slower on the card: the fence and atomics stall every
//    tile and the last column's scan runs in the tail.)
//  - The stencil pass rebuilds D0 and D1 of its tile (plus the next row for
//    D0 and the next column for D1) from the edges and writes the planes.
//
// Both passes share one register tile: warp w owns rows 4w..4w+3 and lane l
// columns 4l..4l+3, so every thread holds a 4 x 4 block of p.
//  - D0 (row prefix): an in-thread prefix over 4 values, a warp-shuffle scan
//    of the lanes' totals, plus the tile's row edge.  Warp 7 also scans the
//    next row; row 4w+4 reaches warp w through shared memory.
//  - D1 (column prefix): an in-thread prefix over 4 rows, an exclusive scan
//    over the 8 warps' column totals through shared memory, plus the column
//    edge.  Lane 31 also carries column 128; column 4l+4 comes from lane
//    l+1 by shuffle.
//  - Edge sums: row sums by a warp reduction (redux.sync) of the in-thread
//    sums, column sums across warps through shared memory.
// Every scan step keeps all 8 warps busy.
//
// Bound on Hopper.  Stencil pass: bytes; it reads the payload (n*bits/8
// bytes) or the residual plane (4n bytes) once plus the small edge arrays,
// and writes 4 bytes per element per output plane.  Payload edge pass:
// int32 operations, 7 per residual that the function needs (a shift and a
// mask to take it out, three to unzigzag, a row and a column sum; the
// 64-bit offsets and edge masks come on top), against 0.9 bytes read per
// residual at 7 bits.  Design against both:
//  - One unpack per residual per pass, from shared memory: the payload
//    words of each tile row segment are copied in 16-byte pieces, eight
//    threads a row so that all rows' 64-bit bit offsets are computed at
//    once (a warp walking its rows one after another spent more time on
//    that chain than on the copies).  Up to 16 bits a lane takes its 4
//    values from one 64-bit window of 3 staged words (two funnel shifts),
//    above that one funnel shift each.  The plane source is copied in
//    16-byte pieces where n1 % 4 == 0.
//  - The stencil pass is held to 64 registers so that 4 blocks fit per SM
//    (unbounded, the payload grad instantiation took up to twice as many
//    and fitted 1-3).
//  - The edge pass runs on a persistent grid (blocks per SM from the
//    occupancy API) that copies the next tile's words or residuals with
//    cp.async while it sums the current one; the stencil pass runs one
//    block per tile, which was as fast or faster there (PERF.md).
//  - `what` is a template parameter (4 x 2 stencil instantiations), each
//    doing only its own arithmetic, with 16-byte streaming stores
//    (st.global.cs) where n1 % 4 == 0 and masked scalars at a ragged edge.
//
// Batch.  A batch of B planes (the fields of a batch_stack view, the
// counterpart of the grid axis Pallas prepends under the reference's
// jax.vmap) is one launch of each pass: tile t of the B x n_tiles tiles is
// tile t % n_tiles of field t / n_tiles, whose plane, row edges, column
// edges and outputs start at field b's offset (b n0 n1, b n0 n_ct, b n_rt n1)
// and whose payload bits start at b n_words 32.  The scan restarts at every
// field: rowedge's rows are per field, and each column block scans one
// field's column.  The payload path stages from the 16-byte boundary at or
// before each row segment's first bit counted from the batch's first word,
// so a field whose words do not start on 16 bytes (n_words % 4 != 0) still
// takes 16-byte copies.  prefix_stats2d takes a batch too: the corner sums,
// the stats pass's pairs and its results carry the field as their leading
// axis.
//
// prefix_stats2d (paper Algorithm 4) gives (sum q, sum q^2) of
// q = cumsum(cumsum(p, 0), 1) without writing q.  The TPU kernel carries the
// previous row of q across a sequential grid; here nothing is carried.  The
// same edge pass runs, its scan kernel in a mode that also writes corner
// sums (the column edge summed over each 32 columns, per tile row), so that
// the row of q above a tile is its corner (sum p above and left of it) plus
// a lane scan of its column edge, all on the card.  The stats pass rebuilds
// q on the stencil pass's register tile (D0, then a column prefix from that
// row and the warps above) and sums q and q^2 in f64, exact for
// |q| < 2^26; each block carries its threads' sums over its tiles and
// writes one pair, and a one-block kernel, launched early to wait for the
// tile pass (programmatic dependent launch), sums the pairs in a fixed
// order and rounds to f32 once.  No float atomics: the result is the same
// bits run after run.  Bound: memory, p read twice (edge pass and stats
// pass), 4n bytes each.
//
// A batch of B planes is one launch of each kernel: the stats pass walks
// the B x n_tiles tiles on the persistent grid (tiles of field b after
// those of field b - 1, as the other passes do), and each block writes one
// pair per field, (b, block) of a (B, grid) array: the sums of its tiles of
// field b, or zeros where its tiles skip field b.  The reduction runs one
// block per field.  The f64 sums are exact integers under the bound above,
// so a field's result is the same bits whatever batch it sits in and
// however the grid splits its tiles.
#include "common.cuh"

namespace {

constexpr int TH = 32;                 // tile rows
constexpr int TW = 128;                // tile columns
constexpr int NT = 256;                // threads per block
constexpr int NWARP = NT / 32;
constexpr int ROWS = TH / NWARP;       // rows per warp
constexpr int LD = TW + 8;             // staged row stride in words (16-byte rows)
constexpr int LDT = TW + 4;            // column totals: one row per warp + column TW
constexpr int EW = 168;                // staged edges: coledge at 0, rowedge at 132
constexpr unsigned FULL = 0xffffffffu;

static_assert(ROWS == 4 && TW == 4 * 32 && NT == 2 * TW, "one 4 x 4 block a thread");
static_assert(LD >= 132, "129 values at 31 bits span 129 words from a 16-byte boundary");
static_assert(EW >= 132 + TH + 1, "edge staging");

enum What { DERIV0 = 0, DERIV1 = 1, GRAD = 2, LAP = 3 };

struct Args {
  const void* src;         // payload words or the int32 residual plane(s)
  long long n_words;       // payload words of one field (payload path)
  long long all_words;     // payload words of the batch
  int bits;                // payload width 1..31 (payload path)
  int n0, n1;              // plane
  int batch;               // planes (fields)
  int n_rt, n_ct, n_tiles; // tile rows, tile columns, tiles of one plane
  int n_all;               // tiles of the batch
  hsz::FastDiv by_tiles;   // / n_tiles
  hsz::FastDiv by_ct;      // / n_ct
  hsz::FastDiv by_rb;      // / ceil(n0 / NWARP), the scan's row blocks of one plane
  hsz::FastDiv by_cb;      // / ceil(n1 / SCOLS), the scan's column blocks of one plane
  int32_t* rowedge;        // (batch, n0, n_ct)
  int32_t* coledge;        // (batch, n_rt, n1)
  uint32_t* out0;          // stencil pass: (batch, n0, n1) planes
  uint32_t* out1;          // grad only
  bool vin;                // 16-byte copies: aligned payload, or aligned plane rows
  bool vout;               // output rows are 16-byte aligned (16-byte stores)
};

using hsz::cp_async16;
using hsz::cp_async4;
using hsz::cp_async_commit;
using hsz::cp_async_wait_all;
using hsz::store4;

// Start copying rows i0 .. i0+NR-1, columns j0 .. j0+NC-1 of plane b of the
// input into R (row r at R + r*LD).  Rows outside the plane are left alone
// (row4 reads them as 0).
//  - Payload: the words from the 16-byte boundary at or before each row
//    segment's first bit (counted from the batch's first word) through the
//    last word it touches (row_base gives the segment's bit offset); words
//    past them are never needed, as values right of the plane are masked
//    when unpacked.  Eight threads share a row (each its 16-byte pieces),
//    so all rows' offsets are computed at once.
//  - Plane: residual c at word c, 0 right of the plane; warp w takes rows
//    w, w + 8, ..., a lane 4 residuals (16 bytes where n1 % 4 == 0).
template <bool PAYLOAD, int NR, int NC>
__device__ __forceinline__ void fetch(const Args& a, int b, int i0, int j0, uint32_t* R) {
  const int jend = min(j0 + NC, a.n1);
  if constexpr (PAYLOAD) {
    const auto* words = static_cast<const uint32_t*>(a.src);
    const int part = threadIdx.x & 7;
    const unsigned long long base = (unsigned long long)b * (unsigned long long)a.n_words * 32ull;
    for (int r = threadIdx.x >> 3; r < NR; r += NT / 8) {
      const int i = i0 + r;
      if (i >= a.n0) break;
      uint32_t* row = R + r * LD;
      const unsigned long long k = (unsigned long long)i * (unsigned)a.n1;
      const unsigned long long first = base + (k + j0) * (unsigned)a.bits;
      const unsigned long long end = base + (k + jend) * (unsigned)a.bits;
      const long long g0 = (long long)(first >> 7) << 2;
      const int nw = (int)((long long)((end - 1) >> 5) - g0) + 1;
      if (a.vin) {
        for (int q = 4 * part; q < nw; q += 32) {
          if (g0 + q + 3 < a.all_words) {
            cp_async16(row + q, words + g0 + q);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (g0 + q + e < a.all_words) cp_async4(row + q + e, words + g0 + q + e);
          }
        }
      } else {
        for (int q = part; q < nw; q += 8)
          if (g0 + q < a.all_words) cp_async4(row + q, words + g0 + q);
      }
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < NR; r += NWARP) {
      const int i = i0 + r;
      if (i >= a.n0) break;
      uint32_t* row = R + r * LD;
      const auto* p =
          static_cast<const uint32_t*>(a.src) + ((long long)b * a.n0 + i) * a.n1;
      const int c = 4 * lane, j = j0 + c;
      if (a.vin && j + 3 < a.n1) {
        cp_async16(row + c, p + j);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < a.n1) cp_async4(row + c + e, p + j + e);
          else row[c + e] = 0u;
        }
      }
      if constexpr (NC > TW) {
        if (lane == 0) {
          if (j0 + TW < a.n1) cp_async4(row + TW, p + j0 + TW);
          else row[TW] = 0u;
        }
      }
    }
  }
}

// Bit offset of column 0 of staged row i of plane b from its first staged
// word (the 16-byte boundary at or before it); 32-bit arithmetic wraps
// modulo 2^32, a multiple of 128.
__device__ __forceinline__ int row_base(const Args& a, int b, int i, int j0) {
  return (int)(((unsigned)b * (unsigned)a.n_words * 32u +
                ((unsigned)i * (unsigned)a.n1 + (unsigned)j0) * (unsigned)a.bits) &
               127u);
}

// Residual at column c of a staged row whose column 0 starts at bit `base`
// (plane column j = j0 + c; 0 right of the plane).
template <bool PAYLOAD>
__device__ __forceinline__ uint32_t value_at(const Args& a, const uint32_t* row, int base,
                                             int c, int j) {
  if constexpr (PAYLOAD) {
    const int off = base + c * a.bits;
    const uint32_t u = __funnelshift_r(row[off >> 5], row[(off >> 5) + 1], off & 31) &
                       ((1u << a.bits) - 1u);
    return j < a.n1 ? (uint32_t)hsz::unzigzag(u) : 0u;
  } else {
    return row[c];  // staged as 0 right of the plane
  }
}

// The residuals of staged row r of plane b at columns c0 .. c0+3 (0 outside
// the plane).
template <bool PAYLOAD>
__device__ __forceinline__ void row4(const Args& a, const uint32_t* R, int b, int i0, int j0,
                                     int r, int c0, uint32_t (&v)[4]) {
  const int i = i0 + r;
  if (i >= a.n0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = 0u;
    return;
  }
  const uint32_t* row = R + r * LD;
  if constexpr (PAYLOAD) {
    const int off = row_base(a, b, i, j0) + c0 * a.bits;
    if (a.bits <= 16) {
      // the 4 values lie in 3 staged words: one 64-bit window, 4 shifts
      const int w = off >> 5;
      const uint32_t w0 = row[w], w1 = row[w + 1], w2 = row[w + 2];
      const unsigned long long x =
          ((unsigned long long)__funnelshift_r(w1, w2, off) << 32) | __funnelshift_r(w0, w1, off);
      const uint32_t mask = (1u << a.bits) - 1u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t u = (uint32_t)(x >> (e * a.bits)) & mask;
        v[e] = j0 + c0 + e < a.n1 ? (uint32_t)hsz::unzigzag(u) : 0u;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = value_at<true>(a, row, off - c0 * a.bits, c0 + e, j0 + c0 + e);
    }
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(row + c0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

// One residual: staged row r, column c (plane b).
template <bool PAYLOAD>
__device__ __forceinline__ uint32_t one(const Args& a, const uint32_t* R, int b, int i0, int j0,
                                        int r, int c) {
  const int i = i0 + r;
  if (i >= a.n0) return 0u;
  const uint32_t* row = R + r * LD;
  return value_at<PAYLOAD>(a, row, PAYLOAD ? row_base(a, b, i, j0) : 0, c, j0 + c);
}

// Inclusive prefix sum across the lanes of a warp.
__device__ __forceinline__ uint32_t warp_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t x = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += x;
  }
  return v;
}

// ---------------------------------------------------------------------------
// edge pass
// ---------------------------------------------------------------------------

// Field, tile row and tile column of tile t of the batch: fields in
// order, each one's tiles row-major.  Both divisions by magic numbers: the
// operation-bound payload edge pass spends a visible share of its work on
// a division by a runtime value.
__device__ __forceinline__ void tile_of(const Args& a, int tile, int& b, int& ti, int& tj) {
  b = a.by_tiles.div(tile);
  const int t = tile - b * a.n_tiles;
  ti = a.by_ct.div(t);
  tj = t - ti * a.n_ct;
}

template <bool PAYLOAD>
__device__ __forceinline__ void edges_tile(const Args& a, int b, int ti, int tj,
                                           const uint32_t* R, uint32_t* T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = ti * TH, j0 = tj * TW;
  const int r0 = warp * ROWS, c0 = 4 * lane;
  uint32_t p[ROWS][4];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) row4<PAYLOAD>(a, R, b, i0, j0, r0 + k, c0, p[k]);
  // row sums: in-thread, then one warp reduction per row
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const uint32_t s = __reduce_add_sync(FULL, (p[k][0] + p[k][1]) + (p[k][2] + p[k][3]));
    const int i = i0 + r0 + k;
    if (lane == k && i < a.n0)
      a.rowedge[((long long)b * a.n0 + i) * a.n_ct + tj] = (int32_t)s;
  }
  // column sums: in-thread over 4 rows, then across the 8 warps
  uint32_t ct[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ct[e] = (p[0][e] + p[1][e]) + (p[2][e] + p[3][e]);
  *reinterpret_cast<uint4*>(T + warp * LDT + c0) = make_uint4(ct[0], ct[1], ct[2], ct[3]);
  __syncthreads();
  {
    const int c = threadIdx.x >> 1, h = threadIdx.x & 1;  // two threads a column
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < NWARP / 2; ++w) s += T[(4 * h + w) * LDT + c];
    s += __shfl_xor_sync(FULL, s, 1);
    if (h == 0 && j0 + c < a.n1)
      a.coledge[((long long)b * a.n_rt + ti) * a.n1 + j0 + c] = (int32_t)s;
  }
}

// Held to 51 registers so that the 5 blocks per SM that shared memory
// allows fit (unbounded, the payload instantiation took 58 and fitted 4).
template <bool PAYLOAD>
__global__ void __launch_bounds__(NT, 5) lorenzo_edges_kernel(const Args a) {
  __shared__ __align__(16) uint32_t R[2][TH * LD];
  __shared__ __align__(16) uint32_t T[NWARP * LDT];
  int b, ti, tj;
  tile_of(a, blockIdx.x, b, ti, tj);  // the grid has at most one block a tile
  fetch<PAYLOAD, TH, TW>(a, b, ti * TH, tj * TW, R[0]);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < a.n_all; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    // the next tile's copies run under this tile's work
    const int next = tile + gridDim.x;
    if (next < a.n_all) {
      int nb, ni, nj;
      tile_of(a, next, nb, ni, nj);
      fetch<PAYLOAD, TH, TW>(a, nb, ni * TH, nj * TW, R[buf ^ 1]);
    }
    cp_async_commit();
    tile_of(a, tile, b, ti, tj);
    edges_tile<PAYLOAD>(a, b, ti, tj, R[buf], T);
  }
}

// Exclusive prefixes of the edge sums, in place.  Blocks below n_rb take 8
// rows of one field's rowedge (row block rb of field b at b ceil(n0/8) +
// rb), a warp each, 32 tiles a step with a carry.  The others take 32
// columns of one field's coledge (column block cb of field b at n_rb +
// b n_cb + cb): warp g sums segment g of a column's tile rows (lane =
// column, so each load is one 128-byte row piece), the 8
// segment totals meet in shared memory, and each warp then writes its
// segment's prefixes starting from the totals above it.  A segment is read
// in chunks of SCHUNK loads issued together (a loop with a short runtime
// trip count would wait for each load in turn); a segment of one chunk
// stays in registers for the second half.
// CORNERS (prefix_stats2d): each column block also writes, per tile row ti,
// the sum of its 32 column prefixes, corners[fb, ti, g] (g = the block's
// column group), by one warp reduction; the corner of tile (ti, tj) of
// field fb, sum p over i < 32 ti, j < 128 tj, is then the sum of
// corners[fb, ti, g < TGROUPS tj].
constexpr int SCOLS = 32;            // coledge columns per block
constexpr int TGROUPS = TW / SCOLS;  // column blocks (corner sums) per tile
static_assert(TW % SCOLS == 0, "a tile spans whole column blocks");
constexpr int SSEG = NT / SCOLS;     // segments per column
constexpr int SCHUNK = 16;           // loads in flight per thread

template <bool CORNERS>
__device__ __forceinline__ void scan_edges(const Args& a, int n_rb, int32_t* corners) {
  __shared__ uint32_t S[SSEG][SCOLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < n_rb) {
    const int rbf = (a.n0 + NWARP - 1) / NWARP;  // row blocks of one field
    const int fb = a.by_rb.div(blockIdx.x), i = (blockIdx.x - fb * rbf) * NWARP + warp;
    if (i >= a.n0) return;
    int32_t* row = a.rowedge + ((long long)fb * a.n0 + i) * a.n_ct;
    uint32_t carry = 0u;
    for (int c0 = 0; c0 < a.n_ct; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t v = c < a.n_ct ? (uint32_t)row[c] : 0u;
      const uint32_t inc = warp_scan(v, lane);
      if (c < a.n_ct) row[c] = (int32_t)(carry + inc - v);
      carry += __shfl_sync(FULL, inc, 31);
    }
    return;
  }
  const int n_cb = (a.n1 + SCOLS - 1) / SCOLS;
  const int fb = a.by_cb.div(blockIdx.x - n_rb), cb = blockIdx.x - n_rb - fb * n_cb;
  const int j = cb * SCOLS + lane;
  const int len = (a.n_rt + SSEG - 1) / SSEG;
  const int lo = min(warp * len, a.n_rt), hi = min(lo + len, a.n_rt);
  const bool in = j < a.n1;
  int32_t* col = a.coledge + (long long)fb * a.n_rt * a.n1 + j;
  uint32_t v[SCHUNK];
  uint32_t s = 0u;
  for (int r0 = lo; r0 < hi; r0 += SCHUNK) {
#pragma unroll
    for (int m = 0; m < SCHUNK; ++m)
      v[m] = in && r0 + m < hi ? (uint32_t)col[(long long)(r0 + m) * a.n1] : 0u;
#pragma unroll
    for (int m = 0; m < SCHUNK; ++m) s += v[m];
  }
  S[warp][lane] = s;
  __syncthreads();
  if constexpr (!CORNERS) {
    if (!in) return;
  }
  // (CORNERS: lanes right of the plane stay for the warp reductions, with
  // run and v at 0)
  uint32_t run = 0u;
  for (int g = 0; g < warp; ++g) run += S[g][lane];
  for (int r0 = lo; r0 < hi; r0 += SCHUNK) {
    if (hi - lo > SCHUNK) {
#pragma unroll
      for (int m = 0; m < SCHUNK; ++m)
        v[m] = (CORNERS ? in && r0 + m < hi : r0 + m < hi)
                   ? (uint32_t)col[(long long)(r0 + m) * a.n1]
                   : 0u;
    }
#pragma unroll
    for (int m = 0; m < SCHUNK; ++m) {
      if (r0 + m < hi) {
        if (!CORNERS || in) col[(long long)(r0 + m) * a.n1] = (int32_t)run;
        if constexpr (CORNERS) {
          const uint32_t t = __reduce_add_sync(FULL, run);
          if (lane == 0) corners[((long long)fb * a.n_rt + r0 + m) * n_cb + cb] = (int32_t)t;
        }
      }
      run += v[m];
    }
  }
}

__global__ void __launch_bounds__(NT) lorenzo_scan_kernel(const Args a, int n_rb) {
  scan_edges<false>(a, n_rb, nullptr);
}

// The same with the corner sums, for prefix_stats2d.
__global__ void __launch_bounds__(NT) corner_scan_kernel(const Args a, int n_rb,
                                                         int32_t* corners) {
  scan_edges<true>(a, n_rb, corners);
}

// ---------------------------------------------------------------------------
// stencil pass
// ---------------------------------------------------------------------------

// Start copying the edges of tile (ti, tj) of plane b into E: coledge[b, ti,
// j0 .. j0+128] at 0 .. 128, rowedge[b, i0 .. i0+32, tj] at 132 .. 164, 0
// outside the plane.
__device__ __forceinline__ void fetch_edges(const Args& a, int b, int ti, int tj, uint32_t* E) {
  const int t = threadIdx.x;
  const int i0 = ti * TH, j0 = tj * TW;
  if (t <= TW) {
    const int j = j0 + t;
    if (j < a.n1) cp_async4(E + t, a.coledge + ((long long)b * a.n_rt + ti) * a.n1 + j);
    else E[t] = 0u;
  } else if (t >= 132 && t <= 132 + TH) {
    const int i = i0 + t - 132;
    if (i < a.n0) cp_async4(E + t, a.rowedge + ((long long)b * a.n0 + i) * a.n_ct + tj);
    else E[t] = 0u;
  }
}

template <bool PAYLOAD, int WHAT>
__device__ __forceinline__ void stencil_tile(const Args& a, int b, int ti, int tj,
                                             const uint32_t* R, const uint32_t* E, uint32_t* T,
                                             uint32_t* H) {
  constexpr bool N0 = WHAT != DERIV1;  // needs D0
  constexpr bool N1 = WHAT != DERIV0;  // needs D1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = ti * TH, j0 = tj * TW;
  const int r0 = warp * ROWS, c0 = 4 * lane;
  uint32_t p[ROWS][4];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) row4<PAYLOAD>(a, R, b, i0, j0, r0 + k, c0, p[k]);

  // D1, first half: in-thread prefix down the 4 rows (lane 31 also column
  // 128), the warp's column totals to T
  uint32_t d1[ROWS][4], d1x[ROWS];
  if constexpr (N1) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      d1x[k] = lane == 31 ? one<PAYLOAD>(a, R, b, i0, j0, r0 + k, TW) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[k][e] = p[k][e];
    }
#pragma unroll
    for (int k = 1; k < ROWS; ++k) {
      d1x[k] += d1x[k - 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[k][e] += d1[k - 1][e];
    }
    *reinterpret_cast<uint4*>(T + warp * LDT + c0) =
        make_uint4(d1[3][0], d1[3][1], d1[3][2], d1[3][3]);
    if (lane == 31) T[warp * LDT + TW] = d1x[3];
  }

  // D0: in-thread prefix along the 4 columns, a shuffle scan of the lanes'
  // totals, the row edge; warp 7 also the next row.  Row 4w goes to H[w].
  uint32_t d0[ROWS][4], d0h[4];
  if constexpr (N0) {
    uint32_t inc[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      d0[k][0] = p[k][0];
#pragma unroll
      for (int e = 1; e < 4; ++e) d0[k][e] = d0[k][e - 1] + p[k][e];
      inc[k] = d0[k][3];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const uint32_t x = __shfl_up_sync(FULL, inc[k], off);
        if (lane >= off) inc[k] += x;
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint32_t carry = E[132 + r0 + k] + inc[k] - d0[k][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) d0[k][e] += carry;
    }
    *reinterpret_cast<uint4*>(H + warp * TW + c0) =
        make_uint4(d0[0][0], d0[0][1], d0[0][2], d0[0][3]);
    if (warp == NWARP - 1) {
      row4<PAYLOAD>(a, R, b, i0, j0, TH, c0, d0h);
#pragma unroll
      for (int e = 1; e < 4; ++e) d0h[e] += d0h[e - 1];
      const uint32_t incl = warp_scan(d0h[3], lane);
      const uint32_t carry = E[132 + TH] + incl - d0h[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) d0h[e] += carry;
      *reinterpret_cast<uint4*>(H + NWARP * TW + c0) =
          make_uint4(d0h[0], d0h[1], d0h[2], d0h[3]);
    }
  }
  __syncthreads();

  // D1, second half: the column edge plus the totals of the warps above
  uint32_t d1r[ROWS][4];  // D1 one column to the right
  if constexpr (N1) {
    const uint4 ce = *reinterpret_cast<const uint4*>(E + c0);
    uint32_t base[4] = {ce.x, ce.y, ce.z, ce.w};
    uint32_t basex = E[TW];
#pragma unroll
    for (int w = 0; w < NWARP - 1; ++w) {
      if (w < warp) {
        const uint4 tw = *reinterpret_cast<const uint4*>(T + w * LDT + c0);
        base[0] += tw.x;
        base[1] += tw.y;
        base[2] += tw.z;
        base[3] += tw.w;
        if (lane == 31) basex += T[w * LDT + TW];
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[k][e] += base[e];
      d1x[k] += basex;
      const uint32_t right = __shfl_down_sync(FULL, d1[k][0], 1);
#pragma unroll
      for (int e = 0; e < 3; ++e) d1r[k][e] = d1[k][e + 1];
      d1r[k][3] = lane == 31 ? d1x[k] : right;
    }
  }
  uint32_t d0d[4];  // D0 of the row below the warp's last row
  if constexpr (N0) {
    const uint4 dn = *reinterpret_cast<const uint4*>(H + (warp + 1) * TW + c0);
    d0d[0] = dn.x;
    d0d[1] = dn.y;
    d0d[2] = dn.z;
    d0d[3] = dn.w;
  }

  const int j = j0 + c0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = i0 + r0 + k;
    if (i >= a.n0) break;
    uint32_t o0[4], o1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t d0n = 0u, d0c = 0u, d1n = 0u, d1c = 0u;
      if constexpr (N0) {
        d0c = d0[k][e];
        const int kn = k + 1 < ROWS ? k + 1 : k;
        d0n = k + 1 < ROWS ? d0[kn][e] : d0d[e];
      }
      if constexpr (N1) {
        d1c = d1[k][e];
        d1n = d1r[k][e];
      }
      if constexpr (WHAT == DERIV0) o0[e] = d0n + d0c;
      if constexpr (WHAT == DERIV1) o0[e] = d1n + d1c;
      if constexpr (WHAT == GRAD) {
        o0[e] = d0n + d0c;
        o1[e] = d1n + d1c;
      }
      if constexpr (WHAT == LAP) o0[e] = (d0n - d0c) + (d1n - d1c);
    }
    const long long kk = ((long long)b * a.n0 + i) * a.n1 + j;
    store4(a.out0, kk, j, a.n1, a.vout, o0);
    if constexpr (WHAT == GRAD) store4(a.out1, kk, j, a.n1, a.vout, o1);
  }
}

// One block per tile: the tile's input (rows 0..32, the next row too;
// columns 0..128, the next column too) and its edges, then D0, D1 and the
// planes.  (A persistent grid that copies the next tile during this one was
// no faster on the card; PERF.md.)
template <bool PAYLOAD, int WHAT>
__global__ void __launch_bounds__(NT, 4) lorenzo_stencil_kernel(const Args a) {
  __shared__ __align__(16) uint32_t R[(TH + 1) * LD];
  __shared__ __align__(16) uint32_t E[EW];
  __shared__ __align__(16) uint32_t T[NWARP * LDT];
  __shared__ __align__(16) uint32_t H[(NWARP + 1) * TW];
  int b, ti, tj;
  tile_of(a, blockIdx.x, b, ti, tj);
  fetch<PAYLOAD, TH + 1, TW + 1>(a, b, ti * TH, tj * TW, R);
  fetch_edges(a, b, ti, tj, E);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  stencil_tile<PAYLOAD, WHAT>(a, b, ti, tj, R, E, T, H);
}

// ---------------------------------------------------------------------------
// prefix_stats2d
// ---------------------------------------------------------------------------

// Shared memory of the stats pass: column totals T (one row per warp, then
// the row of q above the tile), the warps' f64 sums, then two buffers of a
// staged tile of p (R) and its edges (E).
constexpr int PS_T = (NWARP + 1) * LDT;            // words of T
constexpr int PS_RED = 2 * NWARP * 2;              // words of 2 x NWARP doubles
constexpr int PS_BUF = TH * LD + EW;               // words of one buffer
constexpr int PS_HEAD = PS_T + PS_RED;             // words before the buffers
static_assert(PS_HEAD % 4 == 0 && PS_BUF % 4 == 0, "16-byte aligned buffers");

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// sum p over i < 32 ti, j < 128 tj of field b: the scan kernel's corner
// sums of its tile row ti over the TGROUPS * tj column groups left of the
// tile.  The first
// 128 groups take 4 loads a lane, issued together; WIDE (a tile right of
// column 4224, see wide_stats) reads the groups past them, one load a lane
// a step.
template <bool WIDE>
__device__ __forceinline__ uint32_t corner_of(const int32_t* __restrict__ corners, int n_rt,
                                              int n_cb, int b, int ti, int tj) {
  const int lane = threadIdx.x & 31;
  const int32_t* row = corners + ((long long)b * n_rt + ti) * n_cb;
  const int n = TGROUPS * tj;
  uint32_t c[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int g = lane + 32 * m;
    c[m] = g < n ? (uint32_t)__ldg(row + g) : 0u;
  }
  uint32_t s = (c[0] + c[1]) + (c[2] + c[3]);
  if constexpr (WIDE) {
    for (int g = 128 + lane; g < n; g += 32) s += (uint32_t)__ldg(row + g);
  }
  return __reduce_add_sync(FULL, s);
}

// q as a double, exactly: the bits of 2^52 + 2^31 + q less 2^52 + 2^31 (one
// f64 add, where a conversion instruction runs at a quarter of its rate).
__device__ __forceinline__ double exact_double(uint32_t q) {
  return __hiloint2double(0x43300000, (int)(q ^ 0x80000000u)) - 4503601774854144.0;
}

// Add the tile's q and q^2 to (s1, s2), f64; rows and columns outside the
// plane are skipped.
__device__ __forceinline__ void sum_q(const uint32_t (&d)[ROWS][4], const uint32_t (&top)[4],
                                      int rows, int cols, double& s1, double& s2) {
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k < rows && e < cols) {
        const double q = exact_double(d[k][e] + top[e]);
        s1 += q;
        s2 = fma(q, q, s2);
      }
}

// Add (sum q, sum q^2) of one tile of q = cumsum(cumsum(p, 0), 1) to the
// thread's (s1, s2), on the stencil pass's register tile: D0 by an
// in-thread prefix, a lane scan and the row edge; q by an in-thread prefix
// of D0 down the warp's 4 rows, the totals of the warps above (T) and the
// row of q above the tile, which warp 0 makes from the corner (`corner`,
// its lanes only) and a lane scan of the column edge.
__device__ __forceinline__ void stats_tile(const Args& a, int ti, int tj, uint32_t corner,
                                           const uint32_t* R, const uint32_t* E, uint32_t* T,
                                           double& s1, double& s2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = ti * TH, j0 = tj * TW;
  const int r0 = warp * ROWS, c0 = 4 * lane;
  uint32_t d[ROWS][4];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) row4<false>(a, R, 0, i0, j0, r0 + k, c0, d[k]);
  // D0
  uint32_t inc[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
#pragma unroll
    for (int e = 1; e < 4; ++e) d[k][e] += d[k][e - 1];
    inc[k] = d[k][3];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint32_t x = __shfl_up_sync(FULL, inc[k], off);
      if (lane >= off) inc[k] += x;
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const uint32_t carry = E[132 + r0 + k] + inc[k] - d[k][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[k][e] += carry;
  }
  // column prefix of D0 down the warp's rows; the warp's totals to T
#pragma unroll
  for (int k = 1; k < ROWS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[k][e] += d[k - 1][e];
  *reinterpret_cast<uint4*>(T + warp * LDT + c0) = make_uint4(d[3][0], d[3][1], d[3][2], d[3][3]);
  if (warp == 0) {  // the row of q above the tile, to T row NWARP
    const uint4 ce = *reinterpret_cast<const uint4*>(E + c0);
    uint32_t top[4] = {ce.x, ce.y, ce.z, ce.w};
#pragma unroll
    for (int e = 1; e < 4; ++e) top[e] += top[e - 1];
    const uint32_t carry = corner + warp_scan(top[3], lane) - top[3];
    *reinterpret_cast<uint4*>(T + NWARP * LDT + c0) =
        make_uint4(top[0] + carry, top[1] + carry, top[2] + carry, top[3] + carry);
  }
  __syncthreads();
  const uint4 tt = *reinterpret_cast<const uint4*>(T + NWARP * LDT + c0);
  uint32_t base[4] = {tt.x, tt.y, tt.z, tt.w};
#pragma unroll
  for (int w = 0; w < NWARP - 1; ++w) {
    if (w < warp) {
      const uint4 tw = *reinterpret_cast<const uint4*>(T + w * LDT + c0);
      base[0] += tw.x;
      base[1] += tw.y;
      base[2] += tw.z;
      base[3] += tw.w;
    }
  }
  sum_q(d, base, min(ROWS, a.n0 - i0 - r0), min(4, a.n1 - j0 - c0), s1, s2);
}

// The pairs of fields lo .. hi - 1 of this block, which its tiles skip:
// zeros.
__device__ __forceinline__ void zero_pairs(double* __restrict__ partials, int lo, int hi) {
  for (int f = lo + (int)threadIdx.x; f < hi; f += NT) {
    const long long k = (long long)f * gridDim.x + blockIdx.x;
    partials[2 * k] = 0.0;
    partials[2 * k + 1] = 0.0;
  }
}

// The block's pair of field b: a warp reduction of the threads' sums, then
// the 8 warps in order.
__device__ __forceinline__ void write_pair(double s1, double s2, double* red,
                                           double* __restrict__ partials, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_sum2(s1, s2);
  if (lane == 0) {
    red[warp] = s1;
    red[NWARP + warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int w = 0; w < NWARP; ++w) {
      x += red[w];
      y += red[NWARP + w];
    }
    const long long k = (long long)b * gridDim.x + blockIdx.x;
    partials[2 * k] = x;
    partials[2 * k + 1] = y;
  }
}

// The stats pass over the tiles of every field: a persistent grid that
// copies the next tile's residuals and edges with cp.async while it sums
// the current one.  Each thread carries its f64 sums over the block's tiles
// of one field; after the block's last tile of a field, a warp reduction
// and the 8 warps in order give the block's pair of that field (the pairs
// of the fields between it and the next tile's are zeros; red is reused
// only after the next iteration's barrier).  WIDE: corner_of's loop past
// 128 corner sums, compiled only for planes that need it (in the narrow
// kernel it cost registers and 5 blocks/SM for 4).
template <bool WIDE>
__global__ void __launch_bounds__(NT) prefix_stats_tile_kernel(const Args a,
                                                               const int32_t* __restrict__ corners,
                                                               double* __restrict__ partials) {
  extern __shared__ __align__(16) uint32_t smem[];
  // let the reduction's blocks be scheduled now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  uint32_t* T = smem;
  double* red = reinterpret_cast<double*>(smem + PS_T);
  uint32_t* B = smem + PS_HEAD;
  const int n_cb = (a.n1 + SCOLS - 1) / SCOLS;
  const int warp = threadIdx.x >> 5;
  int b, ti, tj;
  tile_of(a, blockIdx.x, b, ti, tj);  // the grid has at most one block a tile
  zero_pairs(partials, 0, b);
  fetch<false, TH, TW>(a, b, ti * TH, tj * TW, B);
  fetch_edges(a, b, ti, tj, B + TH * LD);
  cp_async_commit();
  double s1 = 0.0, s2 = 0.0;
  int buf = 0;
  for (int tile = blockIdx.x; tile < a.n_all; tile += gridDim.x, buf ^= 1) {
    const uint32_t corner = warp == 0 ? corner_of<WIDE>(corners, a.n_rt, n_cb, b, ti, tj) : 0u;
    cp_async_wait_all();
    __syncthreads();
    int nb = a.batch, ni = ti, nj = tj;
    const int next = tile + gridDim.x;
    if (next < a.n_all) {
      tile_of(a, next, nb, ni, nj);
      uint32_t* N = B + (buf ^ 1) * PS_BUF;
      fetch<false, TH, TW>(a, nb, ni * TH, nj * TW, N);
      fetch_edges(a, nb, ni, nj, N + TH * LD);
    }
    cp_async_commit();
    const uint32_t* R = B + buf * PS_BUF;
    stats_tile(a, ti, tj, corner, R, R + TH * LD, T, s1, s2);
    if (nb != b) {  // the block's last tile of field b (uniform in the block)
      write_pair(s1, s2, red, partials, b);
      s1 = 0.0;
      s2 = 0.0;
      zero_pairs(partials, b + 1, nb);
    }
    b = nb;
    ti = ni;
    tj = nj;
  }
}

// One block per field: the stats pass's (sum q, sum q^2) pairs of the field
// (n_pairs, one per block of that pass) summed in a fixed order.
__global__ void __launch_bounds__(NT)
prefix_stats_reduce_kernel(const double* __restrict__ partials, long long n_pairs,
                           float* __restrict__ out) {
  __shared__ double red[2][NT / 32];
  // launched early (programmatic dependent launch): wait here until the
  // tile pass has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const double* pairs = partials + 2 * (long long)blockIdx.x * n_pairs;
  double a = 0.0, b = 0.0;
  for (long long k = t; k < n_pairs; k += NT) {
    a += pairs[2 * k];
    b += pairs[2 * k + 1];
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
    out[2 * blockIdx.x] = __double2float_rn(a);
    out[2 * blockIdx.x + 1] = __double2float_rn(b);
  }
}

// ---------------------------------------------------------------------------
// launch configuration
// ---------------------------------------------------------------------------

// Shared memory (static and dynamic), registers and resident blocks per SM
// of one kernel, read once.
struct Config {
  cudaError_t err;
  int smem;
  int regs;
  int per_sm;
};

template <typename K>
Config config_of(K kernel, int dynamic_smem = 0) {
  Config c{cudaSuccess, 0, 0, 0};
  cudaFuncAttributes fa;
  c.err = cudaFuncGetAttributes(&fa, kernel);
  if (c.err == cudaSuccess) {
    c.smem = (int)fa.sharedSizeBytes + dynamic_smem;
    c.regs = fa.numRegs;
    c.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, NT, dynamic_smem);
  }
  return c;
}

template <bool PAYLOAD>
const Config& edges_config() {
  static const Config c = config_of(lorenzo_edges_kernel<PAYLOAD>);
  return c;
}

template <bool PAYLOAD, int WHAT>
const Config& stencil_config() {
  static const Config c = config_of(lorenzo_stencil_kernel<PAYLOAD, WHAT>);
  return c;
}

constexpr int PS_SMEM = (PS_HEAD + 2 * PS_BUF) * (int)sizeof(uint32_t);

template <bool WIDE>
const Config& stats_config() {
  static const Config c = config_of(prefix_stats_tile_kernel<WIDE>, PS_SMEM);
  return c;
}

// Whether a tile lies right of the first 128 corner sums (4224 columns).
bool wide_stats(const Args& a) { return TGROUPS * (a.n_ct - 1) > 128; }

template <bool PAYLOAD>
const Config& stencil_config(int what) {
  switch (what) {
    case DERIV0: return stencil_config<PAYLOAD, DERIV0>();
    case DERIV1: return stencil_config<PAYLOAD, DERIV1>();
    case GRAD: return stencil_config<PAYLOAD, GRAD>();
    default: return stencil_config<PAYLOAD, LAP>();
  }
}

// The edge sums on a persistent grid (as many blocks as can be resident, at
// most one a tile), then their prefixes (and the corner sums if corners is
// not null).
template <bool PAYLOAD>
int launch_edges(const Args& a, int32_t* corners, cudaStream_t s) {
  const Config& c = edges_config<PAYLOAD>();
  if (c.err != cudaSuccess) return (int)c.err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(a.n_all, sms * max(c.per_sm, 1));
  lorenzo_edges_kernel<PAYLOAD><<<grid, NT, 0, s>>>(a);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const int n_rb = a.batch * ((a.n0 + NWARP - 1) / NWARP), n_cb = (a.n1 + SCOLS - 1) / SCOLS;
  if (corners)
    corner_scan_kernel<<<n_rb + a.batch * n_cb, NT, 0, s>>>(a, n_rb, corners);
  else
    lorenzo_scan_kernel<<<n_rb + a.batch * n_cb, NT, 0, s>>>(a, n_rb);
  return (int)cudaGetLastError();
}

template <bool PAYLOAD, int WHAT>
int launch_stencil(const Args& a, cudaStream_t s) {
  lorenzo_stencil_kernel<PAYLOAD, WHAT><<<a.n_all, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAYLOAD>
int dispatch_stencil(const Args& a, int what, cudaStream_t s) {
  switch (what) {
    case DERIV0: return launch_stencil<PAYLOAD, DERIV0>(a, s);
    case DERIV1: return launch_stencil<PAYLOAD, DERIV1>(a, s);
    case GRAD: return launch_stencil<PAYLOAD, GRAD>(a, s);
    default: return launch_stencil<PAYLOAD, LAP>(a, s);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

Args make_args(int from_payload, const void* src, long long n_words, int bits, int n0,
               int n1, int batch) {
  Args a{};
  a.src = src;
  a.n_words = n_words;
  a.all_words = n_words * batch;
  a.bits = from_payload ? bits : 1;
  a.n0 = n0;
  a.n1 = n1;
  a.batch = batch;
  a.n_rt = (n0 + TH - 1) / TH;
  a.n_ct = (n1 + TW - 1) / TW;
  a.n_tiles = a.n_rt * a.n_ct;
  a.n_all = a.n_tiles * batch;
  a.by_tiles = hsz::FastDiv((uint32_t)a.n_tiles);
  a.by_ct = hsz::FastDiv((uint32_t)a.n_ct);
  a.by_rb = hsz::FastDiv((uint32_t)((n0 + NWARP - 1) / NWARP));
  a.by_cb = hsz::FastDiv((uint32_t)((n1 + SCOLS - 1) / SCOLS));
  // the payload is staged from 16-byte boundaries of the batch's words;
  // plane rows (of every field) are 16-byte aligned where n1 % 4 == 0
  a.vin = aligned16(src) && (from_payload || (n1 & 3) == 0);
  return a;
}

bool bad_shape(int from_payload, int bits, int n0, int n1, int batch) {
  if (n0 <= 0 || n1 <= 0 || batch <= 0) return true;
  const long long tiles = (long long)((n0 + TH - 1) / TH) * ((n1 + TW - 1) / TW);
  const long long blocks = ((n0 + NWARP - 1) / NWARP + (n1 + SCOLS - 1) / SCOLS) * (long long)batch;
  if (tiles * batch > 0x7fffffffLL || blocks > 0x7fffffffLL) return true;
  return from_payload && (bits < 1 || bits > 31);
}

// The stats pass's grid over `batch` planes: as many blocks as can be
// resident, at most one a tile of the batch.
int stats_grid(const Args& a, int* grid) {
  const Config& c = wide_stats(a) ? stats_config<true>() : stats_config<false>();
  if (c.err != cudaSuccess) return (int)c.err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *grid = min(a.n_all, sms * max(c.per_sm, 1));
  return 0;
}

}  // namespace

// The tile the edge arrays are cut by.
extern "C" int hsz_lorenzo_tile(int* th, int* tw) {
  *th = TH;
  *tw = TW;
  return 0;
}

// Columns per corner sum (the scan kernel's column block): the corners
// buffer of hsz_lorenzo_edges is (batch, ceil(n0/TH), ceil(n1/cols)).
extern "C" int hsz_corner_cols(int* cols) {
  *cols = SCOLS;
  return 0;
}

// Static shared memory (bytes), registers per thread and resident blocks per
// SM of the edge pass (what < 0) or of the stencil pass for `what`.
extern "C" int hsz_lorenzo_info(int from_payload, int what, int* smem_bytes, int* regs,
                                int* blocks_per_sm) {
  if (what > LAP) return (int)cudaErrorInvalidValue;
  const Config& c = what < 0 ? (from_payload ? edges_config<true>() : edges_config<false>())
                    : from_payload ? stencil_config<true>(what)
                                   : stencil_config<false>(what);
  *smem_bytes = c.smem;
  *regs = c.regs;
  *blocks_per_sm = c.per_sm;
  return (int)c.err;
}

// Edge pass: two launches on one stream, the per-tile sums and their
// exclusive prefixes, over `batch` planes (field b's payload at word b *
// n_words, its plane at b * n0 * n1).  rowedge: (batch, n0, ceil(n1/TW))
// int32, the sum of p left of each tile in each row; coledge: (batch,
// ceil(n0/TH), n1) int32, the sum of p above each tile in each column;
// corners: null, or (batch, ceil(n0/TH), ceil(n1/32)) int32 for
// prefix_stats2d, the column edge summed over each 32 columns.
extern "C" int hsz_lorenzo_edges(int from_payload, const void* src, long long n_words,
                                 int bits, int n0, int n1, int batch, void* rowedge,
                                 void* coledge, void* corners, void* stream) {
  if (bad_shape(from_payload, bits, n0, n1, batch)) return (int)cudaErrorInvalidValue;
  Args a = make_args(from_payload, src, n_words, bits, n0, n1, batch);
  a.rowedge = static_cast<int32_t*>(rowedge);
  a.coledge = static_cast<int32_t*>(coledge);
  auto c = static_cast<int32_t*>(corners);
  auto s = (cudaStream_t)stream;
  return from_payload ? launch_edges<true>(a, c, s) : launch_edges<false>(a, c, s);
}

// Stencil pass over `batch` planes.  rowedge / coledge as the edge pass
// leaves them; out0/out1: (batch, n0, n1) int32 (out1 only for what ==
// GRAD).
extern "C" int hsz_lorenzo_stencil(int from_payload, const void* src, long long n_words,
                                   int bits, int n0, int n1, int batch, const void* rowedge,
                                   const void* coledge, int what, void* out0,
                                   void* out1, void* stream) {
  if (bad_shape(from_payload, bits, n0, n1, batch) || what < DERIV0 || what > LAP)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(from_payload, src, n_words, bits, n0, n1, batch);
  a.rowedge = const_cast<int32_t*>(static_cast<const int32_t*>(rowedge));
  a.coledge = const_cast<int32_t*>(static_cast<const int32_t*>(coledge));
  a.out0 = static_cast<uint32_t*>(out0);
  a.out1 = static_cast<uint32_t*>(out1);
  a.vout = (n1 & 3) == 0 && aligned16(out0) && (out1 == nullptr || aligned16(out1));
  auto s = (cudaStream_t)stream;
  return from_payload ? dispatch_stencil<true>(a, what, s) : dispatch_stencil<false>(a, what, s);
}

// p: (batch, n0, n1) int32; rowedge, coledge, corners as the edge pass
// leaves them for prefix_stats2d; partials: n_pairs f64 pairs of scratch,
// at least batch * hsz_prefix_stats_grid (field b's pair of block k at
// b * grid + k); out: (batch, 2) f32.  Launches the tile pass on a
// persistent grid and the fixed-order reduction (a block per field) on one
// stream, the reduction by programmatic dependent launch.
extern "C" int hsz_prefix_stats(const void* p, int n0, int n1, int batch, const void* rowedge,
                                const void* coledge, const void* corners, void* partials,
                                long long n_pairs, void* out, void* stream) {
  if (bad_shape(0, 0, n0, n1, batch)) return (int)cudaErrorInvalidValue;
  Args a = make_args(0, p, 0, 0, n0, n1, batch);
  a.rowedge = const_cast<int32_t*>(static_cast<const int32_t*>(rowedge));
  a.coledge = const_cast<int32_t*>(static_cast<const int32_t*>(coledge));
  auto s = (cudaStream_t)stream;
  const bool wide = wide_stats(a);
  int grid = 0;
  if (int err = stats_grid(a, &grid)) return err;
  if ((long long)grid * batch > n_pairs) return (int)cudaErrorInvalidValue;
  const auto c_in = static_cast<const int32_t*>(corners);
  const auto pairs = static_cast<double*>(partials);
  if (wide)
    prefix_stats_tile_kernel<true><<<grid, NT, PS_SMEM, s>>>(a, c_in, pairs);
  else
    prefix_stats_tile_kernel<false><<<grid, NT, PS_SMEM, s>>>(a, c_in, pairs);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, prefix_stats_reduce_kernel,
                                 static_cast<const double*>(partials), (long long)grid,
                                 static_cast<float*>(out));
}

// Blocks of the prefix_stats2d stats pass over `batch` (n0, n1) planes: the
// partials of hsz_prefix_stats hold `batch` times that many pairs.
extern "C" int hsz_prefix_stats_grid(int n0, int n1, int batch, int* grid) {
  if (bad_shape(0, 0, n0, n1, batch)) return (int)cudaErrorInvalidValue;
  return stats_grid(make_args(0, nullptr, 0, 0, n0, n1, batch), grid);
}

// Shared memory (bytes), registers per thread and resident blocks per SM of
// the prefix_stats2d stats pass (planes up to 4224 columns).
extern "C" int hsz_prefix_stats_info(int* smem_bytes, int* regs, int* blocks_per_sm) {
  const Config& c = stats_config<false>();
  *smem_bytes = c.smem;
  *regs = c.regs;
  *blocks_per_sm = c.per_sm;
  return (int)c.err;
}

namespace hsz {
const KernelInfo lorenzo_info[] = {
    {"lorenzo_edges_kernel<false>", (const void*)lorenzo_edges_kernel<false>, NT, 0},
    {"lorenzo_edges_kernel<true>", (const void*)lorenzo_edges_kernel<true>, NT, 0},
    {"lorenzo_scan_kernel", (const void*)lorenzo_scan_kernel, NT, 0},
    {"corner_scan_kernel", (const void*)corner_scan_kernel, NT, 0},
    {"lorenzo_stencil_kernel<false, DERIV0>", (const void*)
     lorenzo_stencil_kernel<false, DERIV0>, NT, 0},
    {"lorenzo_stencil_kernel<false, DERIV1>", (const void*)
     lorenzo_stencil_kernel<false, DERIV1>, NT, 0},
    {"lorenzo_stencil_kernel<false, GRAD>", (const void*)
     lorenzo_stencil_kernel<false, GRAD>, NT, 0},
    {"lorenzo_stencil_kernel<false, LAP>", (const void*)
     lorenzo_stencil_kernel<false, LAP>, NT, 0},
    {"lorenzo_stencil_kernel<true, DERIV0>", (const void*)
     lorenzo_stencil_kernel<true, DERIV0>, NT, 0},
    {"lorenzo_stencil_kernel<true, DERIV1>", (const void*)
     lorenzo_stencil_kernel<true, DERIV1>, NT, 0},
    {"lorenzo_stencil_kernel<true, GRAD>", (const void*)
     lorenzo_stencil_kernel<true, GRAD>, NT, 0},
    {"lorenzo_stencil_kernel<true, LAP>", (const void*)
     lorenzo_stencil_kernel<true, LAP>, NT, 0},
    {"prefix_stats_tile_kernel<false>", (const void*)prefix_stats_tile_kernel<false>, NT,
     PS_SMEM},
    {"prefix_stats_tile_kernel<true>", (const void*)prefix_stats_tile_kernel<true>, NT,
     PS_SMEM},
    {"prefix_stats_reduce_kernel", (const void*)prefix_stats_reduce_kernel, NT, 0},
};
const KernelTable lorenzo_kernels = {lorenzo_info, 15};
}  // namespace hsz
