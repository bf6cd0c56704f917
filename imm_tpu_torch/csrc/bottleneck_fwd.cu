// Fused landmark bottleneck forward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/fused.py:_bottleneck_kernel, the Pallas TPU kernel
// launched by _bottleneck_pallas_fwd. Per image b of (B, H, W, K) f32
// heatmaps: the y and x marginal means, a softmax at temperature T over each
// axis and the expectation against the [-1, 1] ruler give coords (B, K, 2) in
// (y, x) order; then the 'rot' Gaussian exp(-s^2((ry-cy)^2 + (rx-cx)^2)) is
// rendered to (B, OH, OW, K), channel-last.
//
// What bounds it: device-memory bytes and launch latency. At the serving
// shape (128, 16, 16, 10) it moves 2.6 MB, about 0.8 us at 3.35 TB/s, and
// does a few thousand FLOPs per image, so the launch itself dominates.
// Design: one block per image. At 16x16x10 the whole map (10 KB; 30 KB at
// K=30) fits one block's shared memory, so the block copies it in once with
// coalesced loads and every reduction reads shared memory: the heatmap is
// read from device memory exactly once. One warp per landmark does the two
// max-subtracted softmaxes. The maps are written in NHWC order, neighbouring
// threads on neighbouring addresses. Above 48 KB of shared memory the launch
// opts in to the larger dynamic limit; the wrapper refuses shapes above 227 KB.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

// i * (2 / (n - 1)) - 1, as the Pallas kernel builds its ruler
// (fused.py:_ruler); n == 1 gives -1, as linspace(-1, 1, 1) does.
__device__ __forceinline__ float ruler(int i, int n) {
  return n > 1 ? i * (2.0f / (n - 1)) - 1.0f : -1.0f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp: softmax over i of marg[i * K + k] * inv_t, then its expectation
// against the ruler of length n. Every lane returns the result.
__device__ float softmax_expectation(const float* marg, int n, int K, int k,
                                     float inv_t, int lane) {
  float m = -CUDART_INF_F;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, marg[i * K + k] * inv_t);
  m = warp_max(m);
  float se = 0.0f, ser = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(marg[i * K + k] * inv_t - m);
    se += e;
    ser += e * ruler(i, n);
  }
  return warp_sum(ser) / warp_sum(se);
}

__global__ void __launch_bounds__(kThreads)
bottleneck_fwd_kernel(const float* __restrict__ heat, float* __restrict__ coords,
                      float* __restrict__ maps, int H, int W, int K, int OH,
                      int OW, float inv_t, float s2) {
  extern __shared__ float smem[];
  const int n_in = H * W * K;
  float* tile = smem;            // (H, W, K) heatmap of this image
  float* ymarg = tile + n_in;    // (H, K) mean over x
  float* xmarg = ymarg + H * K;  // (W, K) mean over y
  float* cyx = xmarg + W * K;    // (K, 2) coords
  const size_t b = blockIdx.x;

  const float* src = heat + b * n_in;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) tile[i] = src[i];
  __syncthreads();

  for (int i = threadIdx.x; i < H * K; i += blockDim.x) {
    const int h = i / K, k = i - h * K;
    const float* row = tile + h * W * K + k;
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s += row[w * K];
    ymarg[i] = s / W;
  }
  for (int i = threadIdx.x; i < W * K; i += blockDim.x) {
    const int w = i / K, k = i - w * K;
    const float* col = tile + w * K + k;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += col[h * W * K];
    xmarg[i] = s / H;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += blockDim.x >> 5) {
    const float cy = softmax_expectation(ymarg, H, K, k, inv_t, lane);
    const float cx = softmax_expectation(xmarg, W, K, k, inv_t, lane);
    if (lane == 0) {
      cyx[2 * k] = cy;
      cyx[2 * k + 1] = cx;
      coords[(b * K + k) * 2] = cy;
      coords[(b * K + k) * 2 + 1] = cx;
    }
  }
  __syncthreads();

  const int n_out = OH * OW * K;
  float* dst = maps + b * n_out;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int k = i % K, p = i / K;
    const float dy = ruler(p / OW, OH) - cyx[2 * k];
    const float dx = ruler(p % OW, OW) - cyx[2 * k + 1];
    dst[i] = expf(-((dy * dy + dx * dx) * s2));
  }
}

}  // namespace

// heat (B, H, W, K), coords (B, K, 2), maps (B, OH, OW, K): contiguous f32 on
// the device. Launches on `stream` and returns cudaGetLastError().
extern "C" int bottleneck_fwd(const void* heat, void* coords, void* maps, int B,
                              int H, int W, int K, int OH, int OW, float inv_t,
                              float s2, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)H * W * K + (size_t)(H + W) * K + 2 * (size_t)K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bottleneck_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bottleneck_fwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)heat, (float*)coords, (float*)maps, H, W, K, OH, OW, inv_t, s2);
  return (int)cudaGetLastError();
}
