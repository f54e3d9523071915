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
// Design.  The Pallas kernel walks a sequential grid axis over K/V blocks,
// carrying the softmax state in VMEM scratch.  On Hopper blocks run in no
// order, so here one block owns one (batch*head, query tile) pair, on
// blockIdx.x alone (B*H*tiles passes gridDim.y's 65,535 for a full
// 8,192-window prediction chunk), and loops over 32-key tiles of K and V itself, staged in shared
// memory with keys past T zeroed and their scores masked to -inf.
// Exponentials are exp2f of scores pre-scaled by log2(e)/sqrt(D).
//
// - bfloat16 (the model's type): each warp owns 16 query rows and runs both
//   products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate).  Q stays in registers as A fragments; S = Q K^T comes out
//   in the accumulator layout, which is already the A-fragment layout of
//   P for O += P V once P is rounded to bf16, so P never touches shared
//   memory.  V is staged transposed, so both B operands are 32-bit loads,
//   and the row strides are padded by 16 bytes so those loads hit 32
//   distinct banks.  D is padded with zeros to 16, 32, 64 or 128.
// - float32 (the parity checks): one thread per query row on the FP32
//   pipes, q row and numerator in registers, each key a shared-memory
//   broadcast, the softmax state updated every 8 keys (4 for D > 32).
//
// What bounds it on the H100.  At the transformer's shapes (D = 16 or 32,
// T = 200 or 25) the matrix products are small: the function's bound is
// the T^2 exponentials on the special-function units (T = 200) or the bytes
// of q, k, v and out (T = 25).  The bf16 path keeps the products on the
// tensor cores so the exponentials and the softmax arithmetic around them
// are what it spends its issue slots on; it reads K and V once per query
// tile from L2 and writes no intermediate to device memory.  What it does
// not do yet: pipeline the next tile's load behind this tile's products
// (cp.async or TMA), or pack several heads of a short sequence into one
// block (at T = 25 a block's two warps do 32 rows of which 25 are real).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 32;   // keys per shared-memory tile
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

// two floats rounded to bf16 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>  // D padded to a multiple of 16
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int heads, int t_len, int d, int q_tiles, Strides st,
               float scale_log2) {
  constexpr int KS = DP + 8;      // k_s row stride: 16 bytes of padding
  constexpr int VS = kTileK + 8;  // vt_s row stride, likewise
  constexpr int KD = DP / 16;     // k-steps of S = Q K^T
  constexpr int ND = DP / 8;      // n-tiles of O
  constexpr int NK = kTileK / 8;  // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 k_s[kTileK * KS];  // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 vt_s[DP * VS];     // [dim][key]

  const int warps = blockDim.x / 32;
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int c = lane % 4;  // fragment column pair
  const int row0 = (tile * warps + threadIdx.x / 32) * 16;
  const bool warp_active = row0 < t_len;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;
  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kb = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + h * st.vh;

  // Q as A fragments, zero past T and past d
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? r_hi : r_lo;
      const int col = kk * 16 + (r >> 1) * 8 + c * 2;
      qa[kk][r] = (row < t_len && col < d) ? load_pair(qb + row * st.qt + col) : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
  float den_lo = 0.0f, den_hi = 0.0f;        // this lane's share of the sum

  for (int k0 = 0; k0 < t_len; k0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    // stage K row-major and V transposed, 16 bytes per load
    for (int idx = threadIdx.x; idx < kTileK * DP / 8; idx += blockDim.x) {
      const int j = idx / (DP / 8);
      const int i = (idx % (DP / 8)) * 8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < t_len && i < d) {
        kv = *reinterpret_cast<const uint4*>(kb + key * st.kt + i);
        vv = *reinterpret_cast<const uint4*>(vb + key * st.vt + i);
      }
      *reinterpret_cast<uint4*>(&k_s[j * KS + i]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(i + e) * VS + j] = ve[e];
    }
    __syncthreads();
    if (!warp_active) continue;

    // S = Q K^T for this warp's 16 rows and the tile's 32 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const __nv_bfloat16* kr = &k_s[(n * 8 + g) * KS + c * 2];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_bf16(s[n], qa[kk], load_pair(kr + kk * 16), load_pair(kr + kk * 16 + 8));
      }
    }
    // scale, mask keys past T, take the new row maxima (over the quad)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + c * 2 + e < t_len;
        s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
        s[n][2 + e] = valid ? s[n][2 + e] * scale_log2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    }
    // every tile holds at least one key below T, so the maxima are finite
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = exp2f(m_lo - mn_lo);
    const float corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    den_lo *= corr_lo;
    den_hi *= corr_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr_lo;
      o[n][1] *= corr_lo;
      o[n][2] *= corr_hi;
      o[n][3] *= corr_hi;
    }
    // P = exp2(S - m): the sum takes it unrounded, the product in bf16.
    // S's n-tiles 2t and 2t+1 are the two column halves of P's A fragment t.
    uint32_t pa[NK / 2][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float p0 = exp2f(s[n][0] - mn_lo);
      const float p1 = exp2f(s[n][1] - mn_lo);
      const float p2 = exp2f(s[n][2] - mn_hi);
      const float p3 = exp2f(s[n][3] - mn_hi);
      den_lo += p0 + p1;
      den_hi += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const __nv_bfloat16* vr = &vt_s[(n * 8 + g) * VS + c * 2];
#pragma unroll
      for (int t = 0; t < NK / 2; ++t) {
        mma_bf16(o[n], pa[t], load_pair(vr + t * 16), load_pair(vr + t * 16 + 8));
      }
    }
  }

  if (!warp_active) return;
  den_lo = quad_sum(den_lo);
  den_hi = quad_sum(den_hi);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + c * 2;
    if (col >= d) continue;
    if (r_lo < t_len) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * t_len + r_lo) * heads + h) * d + col) =
          pack_bf16(o[n][0] / den_lo, o[n][1] / den_lo);
    }
    if (r_hi < t_len) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * t_len + r_hi) * heads + h) * d + col) =
          pack_bf16(o[n][2] / den_hi, o[n][3] / den_hi);
    }
  }
  if (lse != nullptr && c == 0) {
    if (r_lo < t_len) lse[(long long)bh * t_len + r_lo] = m_lo * kLn2 + logf(den_lo);
    if (r_hi < t_len) lse[(long long)bh * t_len + r_hi] = m_hi * kLn2 + logf(den_hi);
  }
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

template <int DP>
void launch_bf16(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int t_len, int heads, int d,
                 const Strides& st, float scale_log2, cudaStream_t stream,
                 int* err) {
  const int warps = min(4, (t_len + 15) / 16);
  const int q_tiles = (t_len + 16 * warps - 1) / (16 * warps);
  const long long blocks = (long long)batch * heads * q_tiles;
  if (blocks > INT_MAX) {
    *err = (int)cudaErrorInvalidValue;
    return;
  }
  flash_fwd_bf16<DP><<<(int)blocks, 32 * warps, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, heads,
      t_len, d, q_tiles, st, scale_log2);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the caller must check this code.  dtype 0 is float32, 1 is
// bfloat16.  Strides are in elements, (batch, time, head) for each of q, k
// and v; lse may be null.  For bfloat16, q, k and v start on 16 bytes and
// their strides are multiples of 8 elements (16-byte loads).
extern "C" int har_flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int t_len, int heads, int d, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, int dtype, void* stream) {
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
    if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
    if (d <= 16) launch_bf16<16>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else if (d <= 32) launch_bf16<32>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else if (d <= 64) launch_bf16<64>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
    else launch_bf16<128>(q, k, v, out, lse, batch, t_len, heads, d, st, scale_log2, s, &err);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
