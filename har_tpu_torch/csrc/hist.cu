// Class histograms for tree induction (kernel K1 of the port).
//
// Replaces har_tpu/ops/pallas_hist.py::_hist_kernel (launched by
// _hist_padded, wrapped by hist_matmul).  It computes, for every tree t,
// (node, class) row wc, feature f and bin b,
//
//     out[t, wc, f*B + b] = sum_r m[t, r, wc] * (bins[r, f] == b)
//
// i.e. m^T @ one_hot(bins) without materializing the indicator.  Bin ids
// outside [0, B) contribute nothing, as in the one-hot matmul.  This dense
// kernel takes any m; the tree grower's row one-hot m goes to the
// row-sparse kernel further down, and no path calls this one.
//
// Design.  One block per (feature tile, wc tile, tree).  Thread
// (f_local, wc_local) owns the B accumulators of one (wc, f) pair in shared
// memory, so no two threads ever add into the same word and there are no
// atomics.  Each thread walks all n rows: it reads bins[r, f] (the same word
// for every thread of that feature: a broadcast) and m[t, r, wc]
// (consecutive wc across a warp: coalesced), and adds the weight into the
// bin's accumulator.  Shared memory is laid out bin-major with a row stride
// of (threads + 1) floats: threads that share a feature share the bin, so
// in the scatter a warp touches consecutive banks, and the final write
// reads consecutive bins through consecutive banks.  At the end the block
// writes its (wc tile, f tile * B) output tile with coalesced stores.
//
// With integer weights (the trees' ones and Poisson bootstrap counts) every
// partial sum is an exact integer below 2^24, so the result is bit-identical
// to the plain version whatever the order of summation.
//
// What bounds it on the H100: the function needs only the bytes of bins, m
// and out (bytes-bound), but this kernel does n adds per output (wc, f)
// pair, dense over m even where m is a one-hot row, and each thread reads
// bins and m through L1 once per row.  It is an issue-bound scatter, not a
// bandwidth-bound one; making it faster is later work (see PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void hist_kernel(const int* __restrict__ bins,
                            const float* __restrict__ m,
                            float* __restrict__ out,
                            int n, int d, int num_bins, int wc_total,
                            int wc_tile, int f_tile) {
  extern __shared__ float acc[];  // [num_bins][threads + 1]
  const int threads = wc_tile * f_tile;
  const int stride = threads + 1;
  const int tid = threadIdx.x;
  const int f_local = tid / wc_tile;
  const int wc_local = tid - f_local * wc_tile;
  const int f0 = blockIdx.x * f_tile;
  const int wc0 = blockIdx.y * wc_tile;
  const int t = blockIdx.z;
  const int f = f0 + f_local;
  const int wc = wc0 + wc_local;

  float* col = acc + tid;
  for (int b = 0; b < num_bins; ++b) col[b * stride] = 0.0f;

  if (f < d && wc < wc_total) {
    const int* bp = bins + f;
    const float* mp = m + (size_t)t * n * wc_total + wc;
    const unsigned nb = (unsigned)num_bins;
    int r = 0;
    for (; r + 4 <= n; r += 4) {
      const int b0 = __ldg(bp + (size_t)(r + 0) * d);
      const int b1 = __ldg(bp + (size_t)(r + 1) * d);
      const int b2 = __ldg(bp + (size_t)(r + 2) * d);
      const int b3 = __ldg(bp + (size_t)(r + 3) * d);
      const float v0 = __ldg(mp + (size_t)(r + 0) * wc_total);
      const float v1 = __ldg(mp + (size_t)(r + 1) * wc_total);
      const float v2 = __ldg(mp + (size_t)(r + 2) * wc_total);
      const float v3 = __ldg(mp + (size_t)(r + 3) * wc_total);
      if ((unsigned)b0 < nb) col[b0 * stride] += v0;
      if ((unsigned)b1 < nb) col[b1 * stride] += v1;
      if ((unsigned)b2 < nb) col[b2 * stride] += v2;
      if ((unsigned)b3 < nb) col[b3 * stride] += v3;
    }
    for (; r < n; ++r) {
      const int b = __ldg(bp + (size_t)r * d);
      const float v = __ldg(mp + (size_t)r * wc_total);
      if ((unsigned)b < nb) col[b * stride] += v;
    }
  }
  __syncthreads();

  // out[t, wc, f*B + b]: a tile row holds f_tile*B consecutive floats
  const int row_len = f_tile * num_bins;
  const size_t out_row = (size_t)d * num_bins;
  float* out_t = out + (size_t)t * wc_total * out_row;
  for (int idx = tid; idx < wc_tile * row_len; idx += threads) {
    const int wl = idx / row_len;
    const int rem = idx - wl * row_len;
    const int fl = rem / num_bins;
    const int b = rem - fl * num_bins;
    const int wcg = wc0 + wl;
    const int fg = f0 + fl;
    if (wcg < wc_total && fg < d) {
      out_t[(size_t)wcg * out_row + (size_t)fg * num_bins + b] =
          acc[b * stride + fl * wc_tile + wl];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, so the caller must
// check this code.  Pointers are device pointers to contiguous tensors:
// bins (n, d) int32, m (T, n, wc_total) f32, out (T, wc_total, d*num_bins).
extern "C" int har_hist_launch(const void* bins, const void* m, void* out,
                               int n, int d, int num_bins, int trees,
                               int wc_total, int wc_tile, int f_tile,
                               void* stream) {
  const size_t smem =
      (size_t)num_bins * (size_t)(wc_tile * f_tile + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + f_tile - 1) / f_tile,
                  (wc_total + wc_tile - 1) / wc_tile, trees);
  hist_kernel<<<grid, wc_tile * f_tile, smem, (cudaStream_t)stream>>>(
      (const int*)bins, (const float*)m, (float*)out, n, d, num_bins,
      wc_total, wc_tile, f_tile);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row-sparse class histograms: the tree path's kernel.
//
// Replaces har_tpu/ops/pallas_hist.py::_hist_kernel on the tree path, where
// m is row one-hot: row r of tree t puts weight[t, r] into column
// slot[t, r] and nothing elsewhere (har_tpu/models/tree.py builds m so).
// It computes
//
//     out[t, s, f*B + b] = sum_r weight[t, r] * (slot[t, r] == s)
//                                            * (bins[r, f] == b)
//
// Rows with weight 0 or a slot outside [0, wc), and bin ids outside
// [0, B), contribute nothing.  It is not the Pallas kernel's spread-matrix
// expansion (MXU work the H100 has no reason to do): it is a scatter.
//
// Design.  A block owns (tree, slot tile, 32 features, row chunk), 32 warps.
// Its shared memory holds the accumulators of its slot tile's live slots:
// acc[slot][feature][stride], stride = B rounded up to an odd number of
// words.  A warp walks 32-row groups of the chunk: lane i reads row i's
// slot and weight (coalesced; the next group's are loaded before this
// group is scattered), a ballot marks the group's rows that belong to this
// block, and rows with weight 0 are skipped whole, their bins never read.
// For each kept row, the row's slot and weight are broadcast by a shuffle,
// lane i reads bins[r, f0 + i] (the warp reads 128 consecutive bytes) and
// does one shared-memory atomic add into acc[slot][i][bin].  Eight kept
// rows are in flight per warp, their loads issued together.  At the end a
// warp writes one feature's B bins per step, coalesced.
//
// Bank conflicts: lane i's word lies in bank (i*stride + bin) mod 32, so
// lanes with equal bins (the common case: one-hot features are mostly
// bin 0) hit 32 distinct banks; with B = 32 unpadded they would all hit
// one, and the final read of consecutive bins is conflict-free too.
//
// Atomics: Hopper has no shared-memory float add; atomicAdd on a float
// there is a compare-and-swap loop, which retries whenever another warp
// wrote the word in between, and every warp of a block adds into the
// same few words when most rows share a slot and a bin.  So each block
// first checks its chunk's weights: when all are integers in [0, 65535]
// (a tree's ones, a forest's Poisson counts) it accumulates in int32 with
// the native shared-memory integer add, exact for up to 32768 rows, and
// converts at the end; otherwise it adds floats.
//
// Filling the card: T trees x slot tiles x feature tiles alone is 23
// blocks for DT's first level on 132 SMs, so the wrapper splits rows into
// chunks until there are about two blocks per SM.  With more than one
// chunk, blocks merge by global atomicAdd of their nonzero accumulators
// into an output the wrapper zeroes; with one, they store their tile.
// The slot tile keeps a block's accumulators within half an SM's shared
// memory (RF's deepest level, 48 slots at B = 32, is two tiles of 24).
//
// Exactness: with integer weights (DT's ones, RF's Poisson counts) every
// partial sum is an exact integer below 2^24, so the result is
// bit-identical to the plain version in any order of the atomics.  Float
// weights agree to rounding (rtol 1e-5).
//
// What bounds it on the H100: bytes.  The adds (kept rows x d, ~14 M for
// an RF chunk's level) are few; the bytes are bins (read once per tree
// from L2, once from HBM), slot, weight, and the output, which grows with
// the level's live width (2^L nodes x C classes): the grower asks for
// exactly that width, not the deepest level's.

namespace {

constexpr int kRowsThreads = 1024;  // 32 warps
constexpr int kRowsUnroll = 8;
// int32 accumulators hold any sum of kMaxIntRows weights of at most
// kMaxIntWeight
constexpr float kMaxIntWeight = 65535.0f;
constexpr int kMaxIntRows = 32768;

__global__ void hist_rows_kernel(const int* __restrict__ bins,
                                 const int* __restrict__ slot,
                                 const float* __restrict__ weight,
                                 float* __restrict__ out,
                                 int n, int d, int num_bins, int wc,
                                 int wc_tile, int slot_tiles, int chunk_rows) {
  extern __shared__ float acc[];  // [ws][32][stride]
  const int stride = num_bins | 1;
  const int t = blockIdx.x / slot_tiles;
  const int s0 = (blockIdx.x - t * slot_tiles) * wc_tile;
  const int ws = min(wc_tile, wc - s0);
  const int f0 = blockIdx.y * 32;
  const int r0 = blockIdx.z * chunk_rows;
  const int r1 = min(n, r0 + chunk_rows);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = kRowsThreads / 32;
  const int f = f0 + lane;
  const bool f_ok = f < d;
  if (ws <= 0) return;  // the whole block: no slot of the tile exists

  const int* slot_t = slot + (size_t)t * n;
  const float* w_t = weight + (size_t)t * n;
  for (int i = threadIdx.x; i < ws * 32 * stride; i += kRowsThreads) acc[i] = 0.0f;
  int not_int = r1 - r0 > kMaxIntRows;
  for (int r = r0 + threadIdx.x; r < r1; r += kRowsThreads) {
    const float w = __ldg(w_t + r);
    not_int |= !(w >= 0.0f && w <= kMaxIntWeight && w == rintf(w));
  }
  // zero bits are 0 in both: the accumulators serve either kind
  const bool as_int = !__syncthreads_or(not_int);

  const unsigned nb = (unsigned)num_bins;
  float* acc_lane = acc + lane * stride;
  const int slot_words = 32 * stride;

  // lane i holds row g + i's slot (relative to the tile) and weight; the
  // next group's are loaded before this group's rows are scattered
  int s_next = -1;
  float w_next = 0.0f;
  if (r0 + warp * 32 + lane < r1) {
    s_next = __ldg(slot_t + r0 + warp * 32 + lane) - s0;
    w_next = __ldg(w_t + r0 + warp * 32 + lane);
  }
  for (int g = r0 + warp * 32; g < r1; g += warps * 32) {
    const int s = s_next;
    const float w = w_next;
    const int r_next = g + warps * 32 + lane;
    s_next = -1;
    w_next = 0.0f;
    if (r_next < r1) {
      s_next = __ldg(slot_t + r_next) - s0;
      w_next = __ldg(w_t + r_next);
    }
    unsigned mask =
        __ballot_sync(0xffffffffu, w != 0.0f && (unsigned)s < (unsigned)ws);
    while (mask) {
      int src[kRowsUnroll];
      int bv[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        src[u] = __ffs(mask) - 1;  // -1 once the group's rows run out
        mask &= mask - 1;
      }
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        bv[u] = -1;
        if (src[u] >= 0 && f_ok) bv[u] = __ldg(bins + (size_t)(g + src[u]) * d + f);
      }
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        if (src[u] >= 0) {  // warp-uniform: every lane shuffles
          const int su = __shfl_sync(0xffffffffu, s, src[u]);
          const float wu = __shfl_sync(0xffffffffu, w, src[u]);
          if ((unsigned)bv[u] < nb) {
            float* p = acc_lane + su * slot_words + bv[u];
            if (as_int) {
              atomicAdd(reinterpret_cast<int*>(p), __float2int_rn(wu));
            } else {
              atomicAdd(p, wu);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // out[t, s0 + sl, (f0 + fl)*B + b]: a warp writes one feature's B bins
  const bool merge = gridDim.z > 1;
  const int fw = min(32, d - f0);
  const size_t row_len = (size_t)d * num_bins;
  float* out_t = out + ((size_t)t * wc + s0) * row_len + (size_t)f0 * num_bins;
  for (int sl = 0; sl < ws; ++sl) {
    for (int fl = warp; fl < fw; fl += warps) {
      const float* a = acc + (sl * 32 + fl) * stride;
      float* o = out_t + sl * row_len + (size_t)fl * num_bins;
      for (int b = lane; b < num_bins; b += 32) {
        const float v = as_int ? (float)__float_as_int(a[b]) : a[b];
        if (!merge) {
          o[b] = v;
        } else if (v != 0.0f) {
          atomicAdd(o + b, v);
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError().  Pointers are device
// pointers to contiguous tensors: bins (n, d) int32, slot (T, n) int32,
// weight (T, n) f32, out (T, wc, d*num_bins) f32, zeroed by the caller when
// chunks > 1.  The tiling (wc_tile, slot_tiles, chunk_rows, chunks) comes
// from har_tpu_torch/ops/hist.py::rows_plan.
extern "C" int har_hist_rows_launch(const void* bins, const void* slot,
                                    const void* weight, void* out, int n,
                                    int d, int num_bins, int trees, int wc,
                                    int wc_tile, int slot_tiles,
                                    int chunk_rows, int chunks, void* stream) {
  const size_t smem =
      (size_t)wc_tile * 32 * (size_t)(num_bins | 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(trees * slot_tiles, (d + 31) / 32, chunks);
  hist_rows_kernel<<<grid, kRowsThreads, smem, (cudaStream_t)stream>>>(
      (const int*)bins, (const int*)slot, (const float*)weight, (float*)out,
      n, d, num_bins, wc, wc_tile, slot_tiles, chunk_rows);
  return (int)cudaGetLastError();
}
