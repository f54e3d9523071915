// Bidirectional fused attention forward (kernel K2 of the port).
//
// Replaces har_tpu/ops/flash_attention.py::_flash_kernel and its
// _online_softmax_step (launched by _flash_bht, with or without with_lse).
// For every batch b, head h and query row r it computes
//
//     out[b, r, h, :] = softmax_k(q[b, r, h, :] . k[b, k, h, :] / sqrt(D)) @ v[b, :, h, :]
//     lse[b, h, r]    = log sum_k exp(q . k / sqrt(D))          (when asked)
//
// with an online softmax (running max, f32 denominator, f32 numerator), so
// the T x T score matrix never leaves the SM.  As in the reference, the
// denominator sums the unrounded probabilities and each probability is
// rounded to the input type before it multiplies V (p.astype(q.dtype)).
//
// Layout.  q, k and v are (B, T, H, D) with any strides over B, T and H and
// unit stride over D, so the wrapper reads them straight out of the fused
// qkv projection without a transpose.  out is contiguous (B, T, H, D); lse
// is contiguous (B, H, T) float32.  D is a multiple of 8 up to 128.
//
// The Pallas kernel walks a sequential grid axis over K/V blocks, carrying
// the softmax state in VMEM scratch.  On Hopper blocks run in no order, so
// each block loops over the keys itself, on blockIdx.x alone (B*H passes
// gridDim.y's 65,535 for a full 8,192-window prediction chunk).
//
// bfloat16 (the model's type) follows a plan made by the wrapper
// (ops/flash_attention.py::flash_plan) and checked here against the same
// arithmetic.  Two routes:
//
// - resident (a head's Q, K and V fit half an SM's shared memory: every
//   main-path shape).  A block owns one batch row and heads_per_block heads
//   with all T query rows of each.  Their Q, K and V go into shared memory
//   once, by 16-byte cp.async copies zero-filled past T and past d, in one
//   commit group and behind one __syncthreads.  The copies walk token by
//   token with heads and dims fastest, so where the group's heads sit side
//   by side (the fused projection) each token's q, k or v of the group is
//   one contiguous read (256 bytes at 4 heads of D = 32).  Warps then walk
//   (head, 16-row tile) work items; no other block reads those K and V.
//   Each output tile goes back into its Q tile, and the block writes its
//   rows out together, again one contiguous run per token.
// - streamed (T past that budget).  A block owns 16 * warps query rows of
//   one head; 32-key chunks of K and V stream through a ring of two
//   shared-memory stages, the next chunk's cp.async copies in flight while
//   this one computes, one __syncthreads per chunk.  (TMA would need a
//   tensor map per strided view, made on the host for every call; 16-byte
//   cp.async takes the strides as they come.)
//
// In both a warp owns 16 query rows and runs both products on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate; wgmma's 64-row
// tiles buy nothing at D = 16 and T = 25).  Q's A fragments and K's B
// fragments come from shared memory by ldmatrix.x4 (Q's again for every
// chunk, which keeps 2 * D / 8 registers free), V's B fragments by
// ldmatrix.x4.trans straight from row-major V.  S = Q K^T comes out in the
// accumulator layout, which is the A-fragment layout of P once P is rounded
// to bf16, so P never touches shared memory.  Shared rows are padded by 16
// bytes, so each 8-row phase of an ldmatrix hits 8 distinct bank groups.
// Keys go in chunks of 32 (64 needed about 128 registers a thread at
// D = 16 and 32, one 13-warp block an SM, and ran slower on the H100).  The
// first chunk sets each row's shift m to its maximum; later chunks keep m
// and take p = exp2(s * scale_log2 - m) at once, one FFMA and one
// ex2.approx.ftz a score, with no row maximum and no rescale, and go back
// for both only when a p passes 2^kSlack (attend_chunk).  Keys are padded
// with zeros to a multiple of the chunk and masked only in the chunk that
// holds key T - 1, where 8 keys past T together skip their exponentials.
// D is padded with zeros to 16, 32, 64 or 128.
//
// What bounds it on the H100.  At T = 200 (the CLI transformer, D = 16):
// the T^2 exponentials on the special-function units (16 per SM per
// clock), and on this design the instructions issued around them: about
// 4% padded rows, the first chunk's maximum, a sum check per chunk and
// per-block setup, all from shared memory once the block's copies land.
// At T = 25 (the packed route, D = 32, 8 heads): the bytes of q, k, v and
// out, each read or written once, in runs of 256 bytes.  On the streamed
// route: the exponentials again, with K and V read once per 16 * warps
// query rows.
//
// float32 (the parity checks): one thread per query row on the FP32 pipes,
// q row and numerator in registers, each key a shared-memory broadcast, the
// softmax state updated every 8 keys (4 for D > 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileK = 32;   // keys per shared-memory tile (float32)
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;  // elements
};

// ------------------------------------------------------------ float32 path

template <int DMAX>
__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int heads, int t_len, int d,
              int q_tiles, Strides st, float scale_log2) {
  // keys per softmax update: fewer for wide heads, so the unrolled
  // products stay small
  constexpr int kChunk = DMAX <= 32 ? 8 : 4;
  __shared__ float k_s[kTileK][DMAX];
  __shared__ float v_s[kTileK][DMAX];

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row = tile * blockDim.x + threadIdx.x;
  const bool active = row < t_len;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  // head dims past d are zero in q, k and v, so the loops below run to DMAX
  float qr[DMAX];
  float acc[DMAX];
  const float* qp = q + b * st.qb + (long long)(active ? row : 0) * st.qt + h * st.qh;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    qr[i] = (active && i < d) ? qp[i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY;  // running max, in log2 units
  float den = 0.0f;

  for (int k0 = 0; k0 < t_len; k0 += kTileK) {
    const int n = min(kTileK, t_len - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kTileK * DMAX; idx += blockDim.x) {
      const int j = idx / DMAX;
      const int i = idx % DMAX;
      const bool in = j < n && i < d;
      k_s[j][i] = in ? kb[(long long)(k0 + j) * st.kt + i] : 0.0f;
      v_s[j][i] = in ? vb[(long long)(k0 + j) * st.vt + i] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) dot = fmaf(qr[i], k_s[j0 + jj][i], dot);
        s[jj] = (j0 + jj < n) ? dot * scale_log2 : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float corr = exp2f(m - m_new);
      den *= corr;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        den += p;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) acc[i] = fmaf(p, v_s[j0 + jj][i], acc[i]);
      }
      m = m_new;
    }
  }

  if (active) {
    float* op = out + (((long long)b * t_len + row) * heads + h) * d;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) op[i] = acc[i] / den;
    }
    if (lse != nullptr) lse[(long long)bh * t_len + row] = m * kLn2 + logf(den);
  }
}

// ----------------------------------------------------------- bfloat16 path

constexpr int kChunk = 32;         // keys per softmax update
constexpr int kSlack = 8;          // log2 headroom of p before the shift moves
constexpr int kSubtiles = kChunk / 16;
constexpr int kStages = 2;         // the streamed route's ring of key chunks
constexpr int kSmemMax = 232448;   // a Hopper block's dynamic shared memory
constexpr int kSmemStatic = 49152;  // what a block takes without an attribute

// Launch bounds: a block has at most max_warps warps, and min_blocks such
// blocks fit an SM's 65,536 registers (ops/flash_attention.py mirrors
// both).  They leave each instance as many registers as it needs without
// spilling: 72 at D = 16 (four 7-warp blocks an SM), 128 above.
__host__ __device__ constexpr int max_warps(int dp) { return dp <= 16 ? 7 : dp <= 64 ? 8 : 4; }
__host__ __device__ constexpr int min_blocks(int dp) { return dp <= 16 ? 4 : 2; }

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously.  With valid false
// the copy reads nothing (src-size 0) and writes zeros, but its source must
// still be an address inside the tensor.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from the shared-memory address `a`, one row
// address per lane (lanes 8i..8i+7 give matrix i's rows); lane l receives
// row l/4, columns 2(l%4) and 2(l%4)+1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// the same, transposed: lane l receives rows 2(l%4) and 2(l%4)+1 of
// column l/4
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a * b on the tensor cores: a is a 16x16 row-major bf16 tile, b a
// 16x8 column-major bf16 tile, d a 16x8 f32 tile, all in the fragment
// layout of the PTX ISA (lane = 4 * group + quad).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, one instruction; results below 2^-126
// flush to zero (they add nothing to an f32 sum that holds 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One tensor's rows as a block copies them: x points at row 0 of the first
// head, st and sh are its time and head strides (elements; the launch checks
// that a batch row's offsets fit 32 bits), tiles is the shared address of
// the first head's tile.
struct Rows_src {
  const bf16* x;
  int st, sh;
  uint32_t tiles;
};

// Block-wide cp.async of rows [row0, row0 + nrows) of `heads` consecutive
// heads of each of the N sources into their shared tiles: head i's tile
// starts head_stride elements after head i-1's, row r at (r - row0) *
// (DP + 8).  Rows from t_len on and dims from d on are zero-filled.
// Consecutive threads take consecutive 16-byte pieces of a row, heads next,
// so side-by-side heads are one contiguous read per row.
template <int DP, int N>
__device__ __forceinline__ void load_rows(const Rows_src (&src)[N], int head_stride, int heads,
                                          int row0, int nrows, int t_len, int d) {
  constexpr int S = DP + 8;
  constexpr int P = DP / 8;  // 16-byte pieces of a row
  const int per_row = heads * P;
  int i = threadIdx.x / per_row;
  int rest = threadIdx.x - i * per_row;
  const int di = blockDim.x / per_row;
  const int dr = blockDim.x - di * per_row;
  for (; i < nrows; i += di) {
    const int hh = rest / P;
    const int piece = rest % P;
    const int row = row0 + i;
    const bool valid = row < t_len && piece * 8 < d;
    const uint32_t dst = (hh * head_stride + i * S + piece * 8) * sizeof(bf16);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* x = valid ? src[n].x + (row * src[n].st + hh * src[n].sh + piece * 8) : src[n].x;
      cp_async16(src[n].tiles + dst, x, valid);
    }
    rest += dr;
    if (rest >= per_row) {
      rest -= per_row;
      ++i;
    }
  }
}

// Block-wide copy of nrows output rows of `heads` heads from shared tiles
// (laid out as load_rows lays them) to the contiguous (rows, num_heads, d)
// output at out, heads h0.., 16 bytes a thread.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const bf16* tiles, int head_stride,
                                           int heads, int nrows, int num_heads, int h0,
                                           int d) {
  constexpr int S = DP + 8;
  constexpr int P = DP / 8;
  const int per_row = heads * P;
  int i = threadIdx.x / per_row;
  int rest = threadIdx.x - i * per_row;
  const int di = blockDim.x / per_row;
  const int dr = blockDim.x - di * per_row;
  for (; i < nrows; i += di) {
    const int hh = rest / P;
    const int piece = rest % P;
    if (piece * 8 < d) {
      *reinterpret_cast<uint4*>(out + ((i * num_heads + h0 + hh) * d + piece * 8)) =
          *reinterpret_cast<const uint4*>(tiles + hh * head_stride + i * S + piece * 8);
    }
    rest += dr;
    if (rest >= per_row) {
      rest -= per_row;
      ++i;
    }
  }
}

// One warp's 16 query rows: a lane holds rows g = lane / 4 and g + 8.
template <int DP>
struct Rows {
  float o[DP / 8][4];    // numerator, accumulator layout
  float m_lo, m_hi;      // running max of the scaled scores, log2 units
  float den_lo, den_hi;  // this lane's share of the denominators
};

template <int DP>
__device__ __forceinline__ void rows_init(Rows<DP>& r) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) r.o[n][0] = r.o[n][1] = r.o[n][2] = r.o[n][3] = 0.0f;
  r.m_lo = r.m_hi = -INFINITY;
  r.den_lo = r.den_hi = 0.0f;
}

// Q's A fragments of the 16-row tile at qs (row stride DP + 8)
template <int DP>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DP / 16][4], const bf16* qs, int lane) {
  const uint32_t a = smem_addr(qs + (lane % 16) * (DP + 8) + (lane / 16) * 8);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qa[kk], a + kk * 32);
}

// This lane's ldmatrix row addresses in a key tile at `keys` (row stride
// DP + 8): for K, matrices (keys 0-7, dims 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15) of a 16-key subtile, the B fragments of its two n-tiles of
// S; for V, (keys 0-7, dims 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15),
// transposed, the B fragments of two 8-dim n-tiles of O.
template <int DP>
__device__ __forceinline__ uint32_t k_lane_addr(const bf16* keys, int lane) {
  return smem_addr(keys + ((lane / 16) * 8 + lane % 8) * (DP + 8) + ((lane / 8) % 2) * 8);
}

template <int DP>
__device__ __forceinline__ uint32_t v_lane_addr(const bf16* keys, int lane) {
  return smem_addr(keys + (((lane / 8) % 2) * 8 + lane % 8) * (DP + 8) + (lane / 16) * 8);
}

// S = Q K^T for one warp's rows and one chunk of kChunk keys whose K tile
// this lane reads at shared address ka (k_lane_addr).  Subtile j's n-tiles
// are 2j (its keys 0-7) and 2j+1 (8-15); one ldmatrix.x4 gives both
// n-tiles' B fragments for one k-step.  In the last chunk (LAST) keys from
// `valid` on are past T, and their scores are masked.
template <int DP, bool LAST>
__device__ __forceinline__ void chunk_scores(float (&s)[2 * kSubtiles][4],
                                             const uint32_t (&qa)[DP / 16][4], uint32_t ka,
                                             int valid, int lane) {
  constexpr int ROW = (DP + 8) * 2;  // bytes of a shared row
  const int c = lane % 4;
#pragma unroll
  for (int j = 0; j < kSubtiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, ka + j * 16 * ROW + kk * 32);
      mma_bf16(s[2 * j], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * j + 1], qa[kk], b[2], b[3]);
    }
  }
  if (LAST) {
#pragma unroll
    for (int n = 0; n < 2 * kSubtiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n * 8 + c * 2 + e >= valid) s[n][e] = s[n][2 + e] = -INFINITY;
      }
    }
  }
}

// Moves the shift m of each row up to the chunk's maximum score (log2
// units) where that is higher, and rescales the sums so far.  Every chunk
// holds a key below T, so the maxima are finite; from m = -inf the
// corrections are exp2(-inf) = 0.
template <int DP>
__device__ __forceinline__ void move_shift(Rows<DP>& r, const float (&s)[2 * kSubtiles][4],
                                           float scale_log2) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * kSubtiles; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
  // scale_log2 > 0 keeps the raw scores' order
  const float mn_lo = fmaxf(r.m_lo, quad_max(mx_lo) * scale_log2);
  const float mn_hi = fmaxf(r.m_hi, quad_max(mx_hi) * scale_log2);
  const float corr_lo = ex2(r.m_lo - mn_lo);
  const float corr_hi = ex2(r.m_hi - mn_hi);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  r.den_lo *= corr_lo;
  r.den_hi *= corr_hi;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    r.o[n][0] *= corr_lo;
    r.o[n][1] *= corr_lo;
    r.o[n][2] *= corr_hi;
    r.o[n][3] *= corr_hi;
  }
}

// p = exp2(s * scale_log2 - m) in place of s, unrounded, with this lane's
// sums of p over its two rows.  8 keys past T (LAST) take p = 0 without
// exponentials.
template <bool LAST>
__device__ __forceinline__ void chunk_exps(float (&s)[2 * kSubtiles][4], float m_lo,
                                           float m_hi, int valid, float scale_log2,
                                           float& sum_lo, float& sum_hi) {
  sum_lo = sum_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < 2 * kSubtiles; ++n) {
    if (LAST && n * 8 >= valid) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      continue;
    }
    s[n][0] = ex2(fmaf(s[n][0], scale_log2, -m_lo));
    s[n][1] = ex2(fmaf(s[n][1], scale_log2, -m_lo));
    s[n][2] = ex2(fmaf(s[n][2], scale_log2, -m_hi));
    s[n][3] = ex2(fmaf(s[n][3], scale_log2, -m_hi));
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
}

// One warp's rows against one chunk of keys (chunk_scores), V's tile read
// at shared address va (v_lane_addr).  The first chunk (FIRST) sets each
// row's shift m to its maximum score.  Later chunks keep m and take p with
// it at once, without a row maximum: a lane whose p sum over a row passes
// 2^kSlack (a score more than about kSlack - 3 above m) sends the warp back
// to recompute the chunk's scores and move m first.  The softmax is the
// same for any shift, the f32 sums and bf16 P hold p up to 2^kSlack without
// loss, and the denominator still sums the unrounded p.
template <int DP, bool LAST, bool FIRST>
__device__ __forceinline__ void attend_chunk(Rows<DP>& r, const uint32_t (&qa)[DP / 16][4],
                                             uint32_t ka, uint32_t va, int valid,
                                             float scale_log2, int lane) {
  constexpr int ROW = (DP + 8) * 2;
  constexpr int ND = DP / 8;  // n-tiles of O
  constexpr float kLimit = float(1 << kSlack);
  float s[2 * kSubtiles][4];
  float sum_lo, sum_hi;
  chunk_scores<DP, LAST>(s, qa, ka, valid, lane);
  if (FIRST) move_shift<DP>(r, s, scale_log2);
  chunk_exps<LAST>(s, r.m_lo, r.m_hi, valid, scale_log2, sum_lo, sum_hi);
  if (!FIRST && __any_sync(0xffffffffu, sum_lo > kLimit || sum_hi > kLimit)) {
    chunk_scores<DP, LAST>(s, qa, ka, valid, lane);
    move_shift<DP>(r, s, scale_log2);
    chunk_exps<LAST>(s, r.m_lo, r.m_hi, valid, scale_log2, sum_lo, sum_hi);
  }
  r.den_lo += sum_lo;
  r.den_hi += sum_hi;

  // O += P V, P in bf16.  S's n-tiles 2j and 2j+1 are the two column halves
  // of P's A fragment j; one ldmatrix.x4.trans of row-major V gives the B
  // fragments of two 8-dim n-tiles for subtile j's 16 keys.
#pragma unroll
  for (int j = 0; j < kSubtiles; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                            pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < ND / 2; ++n) {
      uint32_t b[4];
      ldsm_x4_trans(b, va + j * 16 * ROW + n * 32);
      mma_bf16(r.o[2 * n], pa, b[0], b[1]);
      mma_bf16(r.o[2 * n + 1], pa, b[2], b[3]);
    }
  }
}

// One warp's rows, whose Q tile is at qt, against keys [0, t_len) staged at
// ks and vs, padded with zeros to a multiple of kChunk (the resident
// route).  Q's fragments are re-read from shared memory for every chunk:
// that costs KD ldmatrix a chunk and keeps 2 * DP / 8 registers free.
template <int DP>
__device__ __forceinline__ void attend_all(Rows<DP>& r, const bf16* qt, const bf16* ks,
                                           const bf16* vs, int t_len, float scale_log2,
                                           int lane) {
  constexpr int ROW = (DP + 8) * 2;
  const int last = (t_len - 1) / kChunk * kChunk;
  const uint32_t ka = k_lane_addr<DP>(ks, lane);
  const uint32_t va = v_lane_addr<DP>(vs, lane);
  uint32_t qa[DP / 16][4];
  load_q<DP>(qa, qt, lane);
  if (last == 0) {
    attend_chunk<DP, true, true>(r, qa, ka, va, t_len, scale_log2, lane);
    return;
  }
  attend_chunk<DP, false, true>(r, qa, ka, va, kChunk, scale_log2, lane);
  for (int k0 = kChunk; k0 < last; k0 += kChunk) {
    load_q<DP>(qa, qt, lane);
    attend_chunk<DP, false, false>(r, qa, ka + k0 * ROW, va + k0 * ROW, kChunk, scale_log2,
                                   lane);
  }
  load_q<DP>(qa, qt, lane);
  attend_chunk<DP, true, false>(r, qa, ka + last * ROW, va + last * ROW, t_len - last,
                                scale_log2, lane);
}

// The warp's output tile, O / den rounded to bf16, into shared memory at os
// (row stride DP + 8), and lse of its rows below `rows` (when lse is set)
template <int DP>
__device__ __forceinline__ void finish_rows(const Rows<DP>& r, bf16* os, float* lse, int rows,
                                            int lane) {
  constexpr int S = DP + 8;
  const int g = lane / 4;
  const int c = lane % 4;
  const float den_lo = quad_sum(r.den_lo);
  const float den_hi = quad_sum(r.den_hi);
  const float inv_lo = 1.0f / den_lo;
  const float inv_hi = 1.0f / den_hi;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * S + n * 8 + c * 2) =
        pack_bf16(r.o[n][0] * inv_lo, r.o[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * S + n * 8 + c * 2) =
        pack_bf16(r.o[n][2] * inv_hi, r.o[n][3] * inv_hi);
  }
  if (lse != nullptr && c == 0) {
    if (g < rows) lse[g] = r.m_lo * kLn2 + logf(den_lo);
    if (g + 8 < rows) lse[g + 8] = r.m_hi * kLn2 + logf(den_hi);
  }
}

// Resident route: block = (batch row, group of hpb heads), all T rows.
// Shared memory: Q, K and V tiles of the group, each tp x (DP + 8), tp the
// multiple of kChunk at or above T.
template <int DP>
__global__ void __launch_bounds__(max_warps(DP) * 32, min_blocks(DP))
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int heads, int t_len, int d, int hpb,
               Strides st, float scale_log2) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tp = (t_len + kChunk - 1) / kChunk * kChunk;
  const int tiles = (t_len + 15) / 16;
  const int head_stride = tp * S;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + hpb * head_stride;
  bf16* vs = ks + hpb * head_stride;
  const int groups = heads / hpb;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * hpb;

  const Rows_src qkv[3] = {
      {q + b * st.qb + h0 * st.qh, (int)st.qt, (int)st.qh, smem_addr(qs)},
      {k + b * st.kb + h0 * st.kh, (int)st.kt, (int)st.kh, smem_addr(ks)},
      {v + b * st.vb + h0 * st.vh, (int)st.vt, (int)st.vh, smem_addr(vs)}};
  load_rows<DP>(qkv, head_stride, hpb, 0, tp, t_len, d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (int item = threadIdx.x / 32; item < hpb * tiles; item += blockDim.x / 32) {
    const int hh = item / tiles;
    const int row0 = (item - hh * tiles) * 16;
    bf16* qt = qs + hh * head_stride + row0 * S;
    Rows<DP> r;
    rows_init(r);
    attend_all<DP>(r, qt, ks + hh * head_stride, vs + hh * head_stride, t_len, scale_log2,
                   lane);
    __syncwarp();  // the tile's Q is read before its output overwrites it
    finish_rows<DP>(r, qt,
                    lse == nullptr ? nullptr
                                   : lse + ((long long)b * heads + h0 + hh) * t_len + row0,
                    t_len - row0, lane);
  }
  __syncthreads();
  store_rows<DP>(out + (long long)b * t_len * heads * d, qs, head_stride, hpb, t_len, heads, h0,
                 d);
}

// Streamed route: block = (batch row, head, 16 * warps query rows).
// Shared memory: the Q tile, then kStages chunks of K, then of V.
template <int DP>
__global__ void __launch_bounds__(max_warps(DP) * 32)
flash_fwd_bf16_streamed(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int heads, int t_len, int d,
                        int q_blocks, Strides st, float scale_log2) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qrows = blockDim.x / 2;  // 16 per warp
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + qrows * S;
  bf16* vs = ks + kStages * kChunk * S;
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = (blockIdx.x - bh * q_blocks) * qrows;
  const int tp = (t_len + 15) & ~15;
  const int nchunks = (t_len + kChunk - 1) / kChunk;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;

  const Rows_src qsrc[1] = {{q + b * st.qb + h * st.qh, (int)st.qt, 0, smem_addr(qs)}};
  load_rows<DP>(qsrc, 0, 1, row0, min(qrows, tp - row0), t_len, d);
  const Rows_src kv0[2] = {{kb, (int)st.kt, 0, smem_addr(ks)},
                           {vb, (int)st.vt, 0, smem_addr(vs)}};
  load_rows<DP>(kv0, 0, 1, 0, kChunk, t_len, d);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int wrow0 = threadIdx.x / 32 * 16;
  const bool active = row0 + wrow0 < t_len;
  uint32_t qa[DP / 16][4];
  Rows<DP> r;
  rows_init(r);
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait_all();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    if (kc + 1 < nchunks) {
      const int stage = (kc + 1) % kStages;
      const Rows_src kv[2] = {{kb, (int)st.kt, 0, smem_addr(ks + stage * kChunk * S)},
                              {vb, (int)st.vt, 0, smem_addr(vs + stage * kChunk * S)}};
      load_rows<DP>(kv, 0, 1, (kc + 1) * kChunk, kChunk, t_len, d);
      cp_async_commit();
    }
    if (!active) continue;
    if (kc == 0) load_q<DP>(qa, qs + wrow0 * S, lane);
    const int stage = kc % kStages;
    const uint32_t ka = k_lane_addr<DP>(ks + stage * kChunk * S, lane);
    const uint32_t va = v_lane_addr<DP>(vs + stage * kChunk * S, lane);
    const int valid = t_len - kc * kChunk;
    if (kc == 0) {
      if (nchunks == 1) {
        attend_chunk<DP, true, true>(r, qa, ka, va, valid, scale_log2, lane);
      } else {
        attend_chunk<DP, false, true>(r, qa, ka, va, kChunk, scale_log2, lane);
      }
    } else if (kc + 1 < nchunks) {
      attend_chunk<DP, false, false>(r, qa, ka, va, kChunk, scale_log2, lane);
    } else {
      attend_chunk<DP, true, false>(r, qa, ka, va, valid, scale_log2, lane);
    }
  }
  if (active) {
    __syncwarp();
    finish_rows<DP>(r, qs + wrow0 * S,
                    lse == nullptr ? nullptr
                                   : lse + (long long)bh * t_len + row0 + wrow0,
                    t_len - row0 - wrow0, lane);
  }
  __syncthreads();
  store_rows<DP>(out + ((long long)b * t_len + row0) * heads * d, qs, 0, 1,
                 min(qrows, t_len - row0), heads, h, d);
}

// ----------------------------------------------------------------- launch

template <int DMAX>
void launch_f32(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, int t_len, int heads, int d,
                const Strides& st, float scale_log2, cudaStream_t stream,
                int* err) {
  const int rows = t_len <= 32 ? 32 : t_len <= 64 ? 64 : 128;
  const int q_tiles = (t_len + rows - 1) / rows;
  const long long blocks = (long long)batch * heads * q_tiles;
  if (blocks > INT_MAX) {
    *err = (int)cudaErrorInvalidValue;
    return;
  }
  flash_fwd_f32<DMAX><<<(int)blocks, rows, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, heads, t_len, d, q_tiles, st, scale_log2);
}

// Lets `kernel` take up to kSmemMax bytes of dynamic shared memory on the
// current device: a host call, made once per kernel and device (a launch
// inside a CUDA graph capture finds it done by the calls before).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The plan's route 0 (resident) or 1 (streamed), held to this file's
// arithmetic: the wrapper and the kernel must agree on every byte.
template <int DP>
void launch_bf16(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int t_len, int heads, int d,
                 const Strides& st, float scale_log2, int route, int hpb,
                 int warps, int key_chunk, int smem_bytes, int grid,
                 cudaStream_t stream, int* err) {
  static std::atomic<unsigned long long> resident_ready{0};
  static std::atomic<unsigned long long> streamed_ready{0};
  const long long row_bytes = (DP + 8) * (long long)sizeof(bf16);
  const long long tp = (t_len + 15LL) / 16 * 16;
  const long long tp_keys = (t_len + kChunk - 1LL) / kChunk * kChunk;
  long long smem = 0;
  long long blocks = 0;
  if (route == 0 && hpb >= 1 && heads % hpb == 0) {
    smem = 3LL * hpb * tp_keys * row_bytes;
    blocks = (long long)batch * (heads / hpb);
  } else if (route == 1 && hpb == 1) {
    smem = (16LL * warps + 2LL * kStages * kChunk) * row_bytes;
    blocks = (long long)batch * heads * ((tp + 16LL * warps - 1) / (16LL * warps));
  }
  if (smem == 0 || key_chunk != kChunk || warps < 1 || warps > max_warps(DP) ||
      smem != smem_bytes || smem > kSmemMax || blocks != grid || blocks > INT_MAX) {
    *err = (int)cudaErrorInvalidValue;
    return;
  }
  if (smem_bytes > kSmemStatic) {
    const cudaError_t ready = route == 0
        ? allow_smem(flash_fwd_bf16<DP>, resident_ready)
        : allow_smem(flash_fwd_bf16_streamed<DP>, streamed_ready);
    if (ready != cudaSuccess) {
      *err = (int)ready;
      return;
    }
  }
  if (route == 0) {
    flash_fwd_bf16<DP><<<grid, 32 * warps, smem_bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, heads,
        t_len, d, hpb, st, scale_log2);
  } else {
    flash_fwd_bf16_streamed<DP><<<grid, 32 * warps, smem_bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, heads,
        t_len, d, grid / (batch * heads), st, scale_log2);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the caller must check this code.  dtype 0 is float32, 1 is
// bfloat16.  Strides are in elements, (batch, time, head) for each of q, k
// and v; lse may be null.  For bfloat16, q, k and v start on 16 bytes and
// their strides are multiples of 8 elements (16-byte copies), and the last
// six arguments are the wrapper's plan (flash_plan: route 0 resident or 1
// streamed, heads per block, warps, key chunk, dynamic shared memory bytes,
// grid), refused unless they match this file's arithmetic; float32 ignores
// them.
extern "C" int har_flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int t_len, int heads, int d, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, int dtype, int route,
    int heads_per_block, int warps, int key_chunk, int smem_bytes, int grid,
    void* stream) {
  if (batch < 1 || t_len < 1 || heads < 1 || d < 8 || d > 128 || d % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (dtype == 0) {
    if (d <= 16) launch_f32<16>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else if (d <= 32) launch_f32<32>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else if (d <= 64) launch_f32<64>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else launch_f32<128>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
  } else if (dtype == 1) {
    const long long strides[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
    for (long long x : strides) {
      if (x % 8) return (int)cudaErrorMisalignedAddress;
    }
    // a block's offsets within one batch row are 32-bit
    const long long row_span[3] = {qst * t_len + qsh * heads, kst * t_len + ksh * heads,
                                   vst * t_len + vsh * heads};
    for (long long x : row_span) {
      if (x < 0 || x >= INT_MAX || (long long)t_len * heads * d >= INT_MAX) {
        return (int)cudaErrorInvalidValue;
      }
    }
    if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)out % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
#define HAR_FLASH_BF16(DP)                                                            \
  launch_bf16<DP>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, route, \
                  heads_per_block, warps, key_chunk, smem_bytes, grid, s, &err)
    if (d <= 16) HAR_FLASH_BF16(16);
    else if (d <= 32) HAR_FLASH_BF16(32);
    else if (d <= 64) HAR_FLASH_BF16(64);
    else HAR_FLASH_BF16(128);
#undef HAR_FLASH_BF16
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
