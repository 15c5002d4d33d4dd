// Lorenzo derivative of a rank-3 field, from the packed payload (HSZp-nd,
// stages 2-4).
//
// Replaces no Pallas kernel: the reference declines rank 3 in its fused
// rules, and its torch-rule counterpart takes int32 cumsums over the two
// axes other than a, then D_a[x + e_a] + D_a[x], a float conversion and the
// eps multiply, each a pass over a full-size plane.  Here the payload is
// read and the f32 interior written, and nothing in between is stored.
//
// What it computes.  With p the residuals (padded layout P0 x P1 x P2, the
// field's valid shape n0 x n1 x n2, interior m = n - 2 along every axis)
// the torch rule's answer is
//   out[i] = f32(D_a[i + e_a + 1] + D_a[i + 1]) * eps,   i in [0, m)^3,
// with D_a = the 2-D prefix sum of p over the two other axes.  A prefix
// is linear, so D_a[x + e_a] + D_a[x] is the 2-D prefix of
// r = p[x] + p[x + e_a]: each output slab i_a is the 2-D prefix of one
// plane of r, and no slab needs another's.  Integer adds are unsigned, so
// they wrap modulo 2^32 as torch's int32 cumsum does, and the result is
// the torch rule's bits, overflow included; f32(q) * eps is one
// __int2float_rn and one __fmul_rn, as torch rounds them.
//
// Bound on Hopper: memory.  The payload once (n*bits/8 bytes) and the
// interior written once (4 m0 m1 m2 bytes).  At B = 16 fields of
// 256 x 384 x 384 at 9 bits that is 0.68 + 2.37 GB, 0.91 ms at 3.35 TB/s.
// The design reads the payload about twice.  Axis 2 (the contiguous one) is
// the slab axis there, so its lanes and its slabs run the same way; the
// others march along a row axis.  Every thread takes consecutive columns,
// so neighbouring lanes read neighbouring payload bits and write
// neighbouring floats.
//  - a = 0, 1: lorenzo3d_plane_kernel<a>.  A warp owns one output slab
//    i_a and marches down its rows (axis 1 for a = 0, axis 0 for a = 1)
//    in chunks of CW columns, G groups of 4 a lane: each row's prefix
//    along axis 2 is an in-thread prefix, a warp scan and the row's carry
//    (r at column 0 first), each column's prefix down the rows a carry in
//    shared memory (one row of up to MAXC columns a warp).  It reads both
//    slabs' words (r = p[s] + p[s + 1]), every group's at once, and each
//    chunk's floats go out through a staging row, so a warp stores 128
//    contiguous bytes at a time.  The kernel is bound by its instructions
//    more than by its bytes: G groups a lane share one scan, one carry
//    row and one staging round (at B = 16 Miranda fields, 9 bits, G = 1
//    took 2.07 ms and G = 3 1.47 ms; PERF.md).
//  - a = 2: lorenzo3d_edges_kernel + lorenzo3d_lane_kernel.  A lane owns
//    one column k (r = p[k] + p[k + 1], both from one 64-bit window), a
//    warp SEG rows of axis 1, and a block of up to MAXW warps all of axis
//    1; the block marches down a run of RUN rows of axis 0.  Each step's
//    prefix along axis 1 is in-thread over the warp's rows plus the totals
//    of the warps before it (shared memory, one barrier a step), and each
//    (row, column)'s prefix down axis 0 a carry in shared memory (in
//    registers the kernel spilled).  A warp reads a row segment with one
//    coalesced 128-byte load, each lane its words by shuffle.  (Loading
//    the next step's words under this one, in registers or by cp.async
//    into shared memory, made it slower on the card: PERF.md.)  The edge kernel
//    first writes, for every run, the sum of r above it per (axis-1 row,
//    column) (vedge), so runs are independent: it reads the rows above the
//    last run once more.
// Widths 1..31; a batch of B fields (a batch_stack view: (B, n_words)
// payload, (B,) eps) is one launch of each kernel, the field the top digit
// of the grid.
#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per block (plane and edge kernels)
constexpr int WPB = NT / 32;     // slabs per block (plane kernel)
constexpr int G = 3;             // 4-column groups a lane (plane kernel)
constexpr int CW = 128 * G;      // columns per chunk (plane kernel)
constexpr int MAXC = 2 * CW;     // widest interior row (m2) of the plane kernel
constexpr int SEG = 16;          // axis-1 rows a thread owns (lane kernel)
constexpr int MAXW = 32;         // warps of a lane-kernel block at most
constexpr int RUN = 64;          // axis-0 rows a lane-kernel block marches
constexpr int EROWS = NT / 32;   // axis-1 rows of an edge-kernel block
constexpr int LANE_SMEM = 4 * 32 * SEG * MAXW;  // the lane kernel's carries, at most
constexpr unsigned FULL = 0xffffffffu;

static_assert(CW == 4 * G * 32 && MAXC % CW == 0, "G 4-column groups a lane");

struct Args {
  const uint32_t* words;   // (batch, n_words) payload words
  long long n_words;       // words of one field
  long long all_words;     // words of the batch
  int bits;                // width 1..31
  int p1, p2;              // padded layout (rows of axis 2 are P2 apart)
  int n0, n1, n2;          // valid shape
  int m0, m1, m2;          // interior: n - 2
  int batch;               // fields
  const float* eps;        // (batch,)
  float* out;              // (batch, m0, m1, m2)
  int32_t* vedge;          // a = 2: (batch, runs, n1 - 1, m2)
  int runs;                // a = 2: runs of RUN axis-0 rows, ceil(m0 / RUN)
  int nsb;                 // a = 0, 1: slab blocks of one field
  int nkc;                 // a = 2: column chunks of 32, ceil(m2 / 32)
  int ng;                  // a = 2 edges: row groups of EROWS, ceil((n1 - 1) / EROWS)
};

// Payload word k of the batch, 0 past its end.
__device__ __forceinline__ uint32_t word_at(const Args& a, long long k) {
  return k < a.all_words ? __ldg(a.words + k) : 0u;
}

// Bit offset of element e (flat index in the padded layout) of field b.
__device__ __forceinline__ unsigned long long bit_of(const Args& a, int b,
                                                     unsigned long long e) {
  return ((unsigned long long)b * (unsigned long long)a.n_words * 32ull) + e * (unsigned)a.bits;
}

// A warp's row segment of 33 values (columns k0 + 1 .. k0 + 33 of one
// axis-2 row) from bit `pos`: lane l holds payload word (pos >> 5) + l (0
// past the payload), one coalesced 128-byte load a row, and each lane takes
// its words by shuffle.
__device__ __forceinline__ uint32_t seg_load(const Args& a, unsigned long long pos, int lane) {
  return word_at(a, (long long)(pos >> 5) + lane);
}

// r = p[c] + p[c + 1] of segment columns c, c + 1 (c = the lane): two
// values of up to 31 bits from any offset lie in 3 words.  Lane 31 at 30
// or 31 bits reaches past the warp's 32 words and reads its own.
__device__ __forceinline__ uint32_t seg_pair(const Args& a, uint32_t w, unsigned long long pos,
                                             int lane) {
  const int o = (int)(pos & 31u) + lane * a.bits, t = o >> 5, sh = o & 31;
  uint32_t w0 = __shfl_sync(FULL, w, t & 31), w1 = __shfl_sync(FULL, w, (t + 1) & 31),
           w2 = __shfl_sync(FULL, w, (t + 2) & 31);
  if (t + 2 > 31) {
    const long long k = (long long)(pos >> 5) + t;
    w0 = word_at(a, k);
    w1 = word_at(a, k + 1);
    w2 = word_at(a, k + 2);
  }
  const unsigned long long x =
      ((unsigned long long)__funnelshift_r(w1, w2, sh) << 32) | __funnelshift_r(w0, w1, sh);
  const uint32_t mask = (1u << a.bits) - 1u;
  return (uint32_t)hsz::unzigzag((uint32_t)x & mask) +
         (uint32_t)hsz::unzigzag((uint32_t)(x >> a.bits) & mask);
}

// ---------------------------------------------------------------------------
// a = 0, 1
// ---------------------------------------------------------------------------

// A lane's words of one 4-value group of one slab: from the word holding
// the group's first bit, 3 words (4 values of up to 16 bits lie in one
// 64-bit window) or 5.
struct Words {
  uint32_t w[5];
  int sh;
};

__device__ __forceinline__ void load_words(const Args& a, unsigned long long pos, bool wide,
                                           Words& W) {
  const long long k = (long long)(pos >> 5);
  W.sh = (int)(pos & 31u);
  if (k + 4 < a.all_words) {  // all but the batch's last words: no guards
    const uint32_t* p = a.words + k;
    W.w[0] = __ldg(p);
    W.w[1] = __ldg(p + 1);
    W.w[2] = __ldg(p + 2);
    W.w[3] = wide ? __ldg(p + 3) : 0u;
    W.w[4] = wide ? __ldg(p + 4) : 0u;
  } else {
    W.w[0] = word_at(a, k);
    W.w[1] = word_at(a, k + 1);
    W.w[2] = word_at(a, k + 2);
    W.w[3] = wide ? word_at(a, k + 3) : 0u;
    W.w[4] = wide ? word_at(a, k + 4) : 0u;
  }
}

// The 4 residuals of a window.
__device__ __forceinline__ void residuals4(const Words& W, int bits, bool wide, uint32_t* v) {
  const unsigned long long lo = ((unsigned long long)__funnelshift_r(W.w[1], W.w[2], W.sh) << 32) |
                                __funnelshift_r(W.w[0], W.w[1], W.sh);
  const uint32_t mask = (1u << bits) - 1u;
  if (!wide) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (uint32_t)hsz::unzigzag((uint32_t)(lo >> (e * bits)) & mask);
    return;
  }
  const unsigned long long hi = ((unsigned long long)__funnelshift_r(W.w[3], W.w[4], W.sh) << 32) |
                                __funnelshift_r(W.w[2], W.w[3], W.sh);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = e * bits;
    const uint32_t u = o >= 64 ? (uint32_t)(hi >> (o - 64))
                       : o == 0 ? (uint32_t)lo
                                : (uint32_t)((lo >> o) | (hi << (64 - o)));
    v[e] = (uint32_t)hsz::unzigzag(u & mask);
  }
}

// The residual at bit `pos` (every lane the same: one broadcast).
__device__ __forceinline__ uint32_t residual_at(const Args& a, unsigned long long pos) {
  const long long k = (long long)(pos >> 5);
  return (uint32_t)hsz::unzigzag(__funnelshift_r(word_at(a, k), word_at(a, k + 1), (int)(pos & 31u)) &
                                 ((1u << a.bits) - 1u));
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

// Flat padded index of (slab s, row y, column 0): the slab is axis AXIS,
// the row the other of axes 0 and 1.
template <int AXIS>
__device__ __forceinline__ unsigned long long row_elem(const Args& a, int s, int y) {
  return AXIS == 0 ? ((unsigned long long)s * (unsigned)a.p1 + (unsigned)y) * (unsigned)a.p2
                   : ((unsigned long long)y * (unsigned)a.p1 + (unsigned)s) * (unsigned)a.p2;
}

// Block bx of field b = bx / nsb takes output slabs WPB (bx % nsb) + warp.
// Rows y = 0 .. m_row of the two slabs s = i_a + 1, i_a + 2 feed the
// prefix; rows y >= 1 are written (output row y - 1).  Chunk cc holds
// output columns cc CW + 4 (G lane + g) + e (axis-2 column one more): G
// groups of 4 a lane, so a row's scan, carries and stores are shared by
// 4 G values.
template <int AXIS>
__global__ void __launch_bounds__(NT, 4) lorenzo3d_plane_kernel(const Args a) {
  __shared__ __align__(16) uint32_t C[WPB][MAXC];  // column carries, a row a warp
  __shared__ __align__(16) float S[WPB][CW];       // a chunk's floats, transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.nsb;
  const int sl = (blockIdx.x - b * a.nsb) * WPB + warp;  // output slab i_a
  if (sl >= (AXIS == 0 ? a.m0 : a.m1)) return;
  const int nrow = (AXIS == 0 ? a.m1 : a.m0) + 1;  // rows 0 .. m_row
  const int nch = (a.m2 + CW - 1) / CW;
  const bool wide = a.bits > 16;
  const float eps = a.eps[b];
  for (int c = 4 * lane; c < nch * CW; c += 128)
    *reinterpret_cast<uint4*>(&C[warp][c]) = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  // bit offsets of the two slabs' current rows (column 0); a row is rstep
  // bits after the one before it, a chunk CW values after the one before
  unsigned long long r0 = bit_of(a, b, row_elem<AXIS>(a, sl + 1, 0));
  unsigned long long r1 = bit_of(a, b, row_elem<AXIS>(a, sl + 2, 0));
  const unsigned long long rstep =
      (AXIS == 0 ? (unsigned long long)a.p2 : (unsigned long long)a.p1 * (unsigned)a.p2) *
      (unsigned)a.bits;
  const unsigned long long lane0 = (unsigned long long)(1 + 4 * G * lane) * (unsigned)a.bits;
  const unsigned long long cstep = (unsigned long long)CW * (unsigned)a.bits;
  const unsigned gstep = 4u * (unsigned)a.bits;
  for (int y = 0; y < nrow; ++y, r0 += rstep, r1 += rstep) {
    uint32_t rc = residual_at(a, r0) + residual_at(a, r1);  // the row's prefix left of the chunk
    for (int cc = 0; cc < nch; ++cc) {
      Words w0[G], w1[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {  // every group's words in flight at once
        const unsigned long long c0 = lane0 + (unsigned)cc * cstep + g * gstep;
        load_words(a, r0 + c0, wide, w0[g]);
        load_words(a, r1 + c0, wide, w1[g]);
      }
      uint32_t run[4 * G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t v0[4], v1[4];
        residuals4(w0[g], a.bits, wide, v0);
        residuals4(w1[g], a.bits, wide, v1);
#pragma unroll
        for (int e = 0; e < 4; ++e) run[4 * g + e] = v0[e] + v1[e];
      }
      const int oc = cc * CW + 4 * G * lane;
      uint32_t acc = 0u;
#pragma unroll
      for (int e = 0; e < 4 * G; ++e) {
        acc += oc + e < a.m2 ? run[e] : 0u;
        run[e] = acc;
      }
      const uint32_t incl = warp_scan(acc, lane);
      const uint32_t base = rc + (incl - acc);
      rc += __shfl_sync(FULL, incl, 31);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint4* cp = reinterpret_cast<uint4*>(&C[warp][oc + 4 * g]);
        uint4 q = *cp;
        q.x += base + run[4 * g];
        q.y += base + run[4 * g + 1];
        q.z += base + run[4 * g + 2];
        q.w += base + run[4 * g + 3];
        *cp = q;
        if (y >= 1)
          *reinterpret_cast<float4*>(&S[warp][4 * (G * lane + g)]) = make_float4(
              __fmul_rn(__int2float_rn((int)q.x), eps), __fmul_rn(__int2float_rn((int)q.y), eps),
              __fmul_rn(__int2float_rn((int)q.z), eps), __fmul_rn(__int2float_rn((int)q.w), eps));
      }
      if (y >= 1) {
        __syncwarp();
        const long long i0 = AXIS == 0 ? sl : y - 1, i1 = AXIS == 0 ? y - 1 : sl;
        float* orow = a.out + (((long long)b * a.m0 + i0) * a.m1 + i1) * a.m2;
#pragma unroll
        for (int k = 0; k < 4 * G; ++k) {
          const int col = cc * CW + 32 * k + lane;
          if (col < a.m2) __stcs(orow + col, S[warp][32 * k + lane]);
        }
        __syncwarp();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// a = 2
// ---------------------------------------------------------------------------

// Thread (warp, lane) of block (b, g, kc) (kc fastest): axis-1 row
// y1 = EROWS g + warp, output column k = 32 kc + lane.  vedge[b, j, y1, k]
// = the sum of r over axis-0 rows 0 .. RUN j, for every run j.  A warp
// reads a row segment a step (every lane, in or out of the interior, for
// the shuffles), 8 rows in flight.
__global__ void __launch_bounds__(NT) lorenzo3d_edges_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int t = blockIdx.x;
  const int kc = t % a.nkc;
  t /= a.nkc;
  const int g = t % a.ng, b = t / a.ng;
  const int k = 32 * kc + lane, y1 = EROWS * g + warp;
  if (y1 >= a.n1 - 1) return;
  const bool in = k < a.m2;
  const unsigned long long step = (unsigned long long)a.p1 * (unsigned)a.p2 * (unsigned)a.bits;
  const unsigned long long pos0 = bit_of(a, b, (unsigned long long)y1 * (unsigned)a.p2 + 32u * kc + 1u);
  int32_t* v = a.vedge + ((long long)b * a.runs * (a.n1 - 1) + y1) * a.m2 + k;
  const long long vstride = (long long)(a.n1 - 1) * a.m2;
  uint32_t acc = seg_pair(a, seg_load(a, pos0, lane), pos0, lane);  // row 0
  if (in) v[0] = (int32_t)acc;
  for (int j = 1; j < a.runs; ++j) {
    for (int x0 = RUN * (j - 1) + 1; x0 <= RUN * j; x0 += 8) {
      uint32_t w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = seg_load(a, pos0 + (unsigned long long)(x0 + u) * step, lane);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += seg_pair(a, w[u], pos0 + (unsigned long long)(x0 + u) * step, lane);
    }
    if (in) v[j * vstride] = (int32_t)acc;
  }
}

// Block (b, j, kc) (kc fastest): output column k = 32 kc + lane, output
// rows i1 = SEG warp + l of axis 1, axis-0 rows x0 = 1 + RUN j ..
// (output row x0 - 1).  The run starts from its vedge row, the sum of r
// above it, taken through the same row step; warp 0 also carries column 0
// of axis 1 (r at y1 = 0), which every later row's prefix holds.
__global__ void __launch_bounds__(MAXW * 32) lorenzo3d_lane_kernel(const Args a) {
  __shared__ uint32_t T[2][MAXW][32];  // each warp's row total, by lane
  extern __shared__ uint32_t CY[];     // carries: axis-1 row i1 at CY[32 i1 + lane]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* carry = CY + 32 * SEG * warp + lane;  // the thread's row l at carry[32 l]
  int t = blockIdx.x;
  const int kc = t % a.nkc;
  t /= a.nkc;
  const int j = t % a.runs, b = t / a.runs;
  const int k = 32 * kc + lane;
  const bool in = k < a.m2;
  const float eps = a.eps[b];
  uint32_t v[SEG];
  {
    const int32_t* vrow = a.vedge + ((long long)b * a.runs + j) * (a.n1 - 1) * a.m2 + k;
#pragma unroll
    for (int l = 0; l < SEG; ++l) {
      const int i1 = SEG * warp + l;
      v[l] = in && i1 < a.m1 ? (uint32_t)vrow[(long long)(i1 + 1) * a.m2] : 0u;
    }
    uint32_t run = in && warp == 0 ? (uint32_t)vrow[0] : 0u;
#pragma unroll
    for (int l = 0; l < SEG; ++l) {
      run += v[l];
      v[l] = run;
    }
    T[0][warp][lane] = run;
    __syncthreads();
    uint32_t off = 0u;
    for (int w = 0; w < warp; ++w) off += T[0][w][lane];
#pragma unroll
    for (int l = 0; l < SEG; ++l) carry[32 * l] = off + v[l];
  }
  const int x_end = min(1 + RUN * (j + 1), a.n0 - 1);
  const unsigned long long plane = (unsigned long long)a.p1 * (unsigned)a.p2;
  const unsigned long long p2bits = (unsigned long long)a.p2 * (unsigned)a.bits;
  int buf = 1;
  for (int x0 = 1 + RUN * j; x0 < x_end; ++x0, buf ^= 1) {
    // the warp's SEG rows' segments (a row past the interior reads as 0)
    // and row 0 of axis 1 (warp 0's), all loads in flight at once
    const unsigned long long row = bit_of(a, b, (unsigned long long)x0 * plane + 32u * kc + 1u);
    const unsigned long long pos1 = row + (unsigned long long)(SEG * warp + 1) * p2bits;
#pragma unroll
    for (int l = 0; l < SEG; ++l) v[l] = seg_load(a, pos1 + l * p2bits, lane);
    const uint32_t w0 = seg_load(a, row, lane);
#pragma unroll
    for (int l = 0; l < SEG; ++l) {
      const uint32_t r = seg_pair(a, v[l], pos1 + l * p2bits, lane);
      v[l] = in && SEG * warp + l < a.m1 ? r : 0u;
    }
    const uint32_t r0 = seg_pair(a, w0, row, lane);
    uint32_t run = in && warp == 0 ? r0 : 0u;
#pragma unroll
    for (int l = 0; l < SEG; ++l) {
      run += v[l];
      v[l] = run;
    }
    T[buf][warp][lane] = run;
    __syncthreads();
    uint32_t off = 0u;
    for (int w = 0; w < warp; ++w) off += T[buf][w][lane];
    float* orow = a.out + (((long long)b * a.m0 + (x0 - 1)) * a.m1 + SEG * warp) * a.m2 + k;
#pragma unroll
    for (int l = 0; l < SEG; ++l) {
      const uint32_t q = carry[32 * l] + off + v[l];
      carry[32 * l] = q;
      if (in && SEG * warp + l < a.m1)
        __stcs(orow + (long long)l * a.m2, __fmul_rn(__int2float_rn((int)q), eps));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int cdiv(long long n, long long d) { return (int)((n + d - 1) / d); }

// Shapes the kernels take: 3 or more along every axis, rows of the padded
// layout no shorter than the valid ones, widths 1..31, the axis's width
// limit, grids under 2^31 blocks.
bool bad_shape(int axis, int bits, int p1, int p2, int n0, int n1, int n2, int batch) {
  if (axis < 0 || axis > 2 || bits < 1 || bits > 31 || batch < 1) return true;
  if (n0 < 3 || n1 < 3 || n2 < 3 || p1 < n1 || p2 < n2) return true;
  if (axis < 2 && n2 - 2 > MAXC) return true;
  if (axis == 2 && n1 - 2 > SEG * MAXW) return true;
  const long long slabs = (long long)cdiv(axis == 0 ? n0 - 2 : n1 - 2, WPB) * batch;
  const long long chunks = (long long)cdiv(n2 - 2, 32) * batch;
  const long long lane_grid = chunks * cdiv(n0 - 2, RUN);
  const long long edge_grid = chunks * cdiv(n1 - 1, EROWS);
  return slabs > 0x7fffffffLL || lane_grid > 0x7fffffffLL || edge_grid > 0x7fffffffLL;
}

Args make_args(const void* words, long long n_words, int bits, int p1, int p2, int n0, int n1,
               int n2, int batch) {
  Args a{};
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = n_words;
  a.all_words = n_words * batch;
  a.bits = bits;
  a.p1 = p1;
  a.p2 = p2;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.m0 = n0 - 2;
  a.m1 = n1 - 2;
  a.m2 = n2 - 2;
  a.batch = batch;
  a.runs = cdiv(a.m0, RUN);
  a.nkc = cdiv(a.m2, 32);
  a.ng = cdiv(n1 - 1, EROWS);
  return a;
}

}  // namespace

// Edge pass of axis 2: vedge (batch, ceil((n0 - 2) / RUN), n1 - 1, n2 - 2)
// int32, the sum of r = p[k + 1] + p[k + 2] over axis-0 rows 0 .. RUN j,
// per run j, axis-1 row and output column k.  Field b's payload at word
// b * n_words; (p1, p2) the padded layout's last two extents, (n0, n1, n2)
// the valid shape.
extern "C" int hsz_lorenzo3d_edges(const void* words, long long n_words, int bits, int p1,
                                   int p2, int n0, int n1, int n2, int batch, void* vedge,
                                   void* stream) {
  if (bad_shape(2, bits, p1, p2, n0, n1, n2, batch)) return (int)cudaErrorInvalidValue;
  Args a = make_args(words, n_words, bits, p1, p2, n0, n1, n2, batch);
  a.vedge = static_cast<int32_t*>(vedge);
  lorenzo3d_edges_kernel<<<batch * a.ng * a.nkc, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The derivative along `axis` of `batch` fields: out (batch, n0 - 2, n1 - 2,
// n2 - 2) f32, eps (batch,) f32; vedge as hsz_lorenzo3d_edges leaves it
// (axis 2 only; null otherwise).
extern "C" int hsz_lorenzo3d_stencil(int axis, const void* words, long long n_words, int bits,
                                     int p1, int p2, int n0, int n1, int n2, int batch,
                                     const void* eps, const void* vedge, void* out,
                                     void* stream) {
  if (bad_shape(axis, bits, p1, p2, n0, n1, n2, batch) || (axis == 2 && vedge == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(words, n_words, bits, p1, p2, n0, n1, n2, batch);
  a.eps = static_cast<const float*>(eps);
  a.out = static_cast<float*>(out);
  a.vedge = const_cast<int32_t*>(static_cast<const int32_t*>(vedge));
  auto s = (cudaStream_t)stream;
  if (axis == 2) {
    const int warps = cdiv(a.m1, SEG);
    static const cudaError_t optin = cudaFuncSetAttribute(
        lorenzo3d_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LANE_SMEM);
    if (optin != cudaSuccess) return (int)optin;
    lorenzo3d_lane_kernel<<<batch * a.runs * a.nkc, 32 * warps, 4 * 32 * SEG * warps, s>>>(a);
  } else {
    a.nsb = cdiv(axis == 0 ? a.m0 : a.m1, WPB);
    if (axis == 0)
      lorenzo3d_plane_kernel<0><<<batch * a.nsb, NT, 0, s>>>(a);
    else
      lorenzo3d_plane_kernel<1><<<batch * a.nsb, NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

namespace hsz {
const KernelInfo lorenzo3d_info[] = {
    {"lorenzo3d_plane_kernel<0>", (const void*)lorenzo3d_plane_kernel<0>, NT, 0},
    {"lorenzo3d_plane_kernel<1>", (const void*)lorenzo3d_plane_kernel<1>, NT, 0},
    {"lorenzo3d_edges_kernel", (const void*)lorenzo3d_edges_kernel, NT, 0},
    {"lorenzo3d_lane_kernel", (const void*)lorenzo3d_lane_kernel, MAXW * 32, LANE_SMEM},
};
const KernelTable lorenzo3d_kernels = {lorenzo3d_info, 4};
}  // namespace hsz
