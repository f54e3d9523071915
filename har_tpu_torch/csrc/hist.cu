// Class histograms for tree induction (kernel K1 of the port).
//
// Replaces har_tpu/ops/pallas_hist.py::_hist_kernel (launched by
// _hist_padded, wrapped by hist_matmul).  It computes, for every tree t,
// (node, class) row wc, feature f and bin b,
//
//     out[t, wc, f*B + b] = sum_r m[t, r, wc] * (bins[r, f] == b)
//
// i.e. m^T @ one_hot(bins) without materializing the indicator.  Bin ids
// outside [0, B) contribute nothing, as in the one-hot matmul.
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
