// Fused landmark bottleneck backward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/fused.py:_bottleneck_bwd_kernel, the Pallas TPU kernel
// launched by _bottleneck_pallas_bwd. The VJP of bottleneck_fwd.cu from the
// heatmaps alone: per image and landmark it recomputes the marginal softmaxes
// p, the coords c and the rendered map M, then
//   dc  = dcoords + sum_ij dM * M * 2 s^2 (r - c)     (render term)
//   dz  = p * (r - c) * dc / T                        (softmax-expectation)
//   dH  = dz_y / W (+) dz_x / H                       (mean-marginal broadcast)
// dmaps may be a null pointer (the maps were not used downstream): the render
// term is then skipped and its bytes are never read.
//
// What bounds it: device-memory bytes and launch latency, as the forward. At
// the training shape (128, 16, 16, 10) it moves 3.94 MB (heatmaps, dmaps and
// dcoords in, dH out), about 1.2 us at 3.35 TB/s, against a few thousand
// FLOPs per image. Design: the forward's layout. One block per image; the
// heatmap and the dmaps tile are copied into shared memory once with
// coalesced loads, so each input byte leaves device memory exactly once and
// every reduction reads shared memory. One warp per landmark does both
// softmaxes and the two pixel reductions for dc with shuffles; the block then
// writes dH in NHWC order, neighbouring threads on neighbouring addresses.
// Nothing is kept from the forward but the heatmaps: recomputing p, c and M
// costs less than five residual tensors through device memory.

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

// One warp: marg[i * K + k] (the mean marginal) becomes softmax_i(marg * inv_t)
// in place; returns its expectation against the ruler of length n.
__device__ float softmax_in_place(float* marg, int n, int K, int k, float inv_t, int lane) {
  float m = -CUDART_INF_F;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, marg[i * K + k] * inv_t);
  m = warp_max(m);
  float se = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(marg[i * K + k] * inv_t - m);
    marg[i * K + k] = e;
    se += e;
  }
  se = warp_sum(se);
  float c = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float p = marg[i * K + k] / se;
    marg[i * K + k] = p;
    c += p * ruler(i, n);
  }
  return warp_sum(c);
}

__global__ void __launch_bounds__(kThreads)
bottleneck_bwd_kernel(const float* __restrict__ heat, const float* __restrict__ dcoords,
                      const float* __restrict__ dmaps, float* __restrict__ dheat,
                      int H, int W, int K, int OH, int OW, float inv_t, float s2) {
  extern __shared__ float smem[];
  const int n_in = H * W * K;
  const int n_out = dmaps != nullptr ? OH * OW * K : 0;
  float* tile = smem;           // (H, W, K) heatmap of this image
  float* dm = tile + n_in;      // (OH, OW, K) cotangent of the maps, if any
  float* py = dm + n_out;       // (H, K): y marginal -> p_y -> dz_y
  float* px = py + H * K;       // (W, K): x marginal -> p_x -> dz_x
  const size_t b = blockIdx.x;

  const float* src = heat + b * n_in;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) tile[i] = src[i];
  if (n_out) {
    const float* dsrc = dmaps + b * n_out;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) dm[i] = dsrc[i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < H * K; i += blockDim.x) {
    const int h = i / K, k = i - h * K;
    const float* row = tile + h * W * K + k;
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s += row[w * K];
    py[i] = s / W;
  }
  for (int i = threadIdx.x; i < W * K; i += blockDim.x) {
    const int w = i / K, k = i - w * K;
    const float* col = tile + w * K + k;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += col[h * W * K];
    px[i] = s / H;
  }
  __syncthreads();

  // One warp per landmark. Each lane reads and writes only its own entries
  // of py/px between the shuffles, so no barrier is needed inside.
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += blockDim.x >> 5) {
    const float cy = softmax_in_place(py, H, K, k, inv_t, lane);
    const float cx = softmax_in_place(px, W, K, k, inv_t, lane);
    float ay = 0.0f, ax = 0.0f;
    if (n_out) {
      for (int p = lane; p < OH * OW; p += 32) {
        const float gy = ruler(p / OW, OH) - cy;
        const float gx = ruler(p % OW, OW) - cx;
        const float wgt = dm[p * K + k] * expf(-((gy * gy + gx * gx) * s2)) * (2.0f * s2);
        ay += wgt * gy;
        ax += wgt * gx;
      }
      ay = warp_sum(ay);
      ax = warp_sum(ax);
    }
    const float dcy = (dcoords[(b * K + k) * 2] + ay) * inv_t;
    const float dcx = (dcoords[(b * K + k) * 2 + 1] + ax) * inv_t;
    for (int i = lane; i < H; i += 32) py[i * K + k] *= (ruler(i, H) - cy) * dcy;
    for (int i = lane; i < W; i += 32) px[i * K + k] *= (ruler(i, W) - cx) * dcx;
  }
  __syncthreads();

  float* dst = dheat + b * n_in;
  const float inv_w = 1.0f / W, inv_h = 1.0f / H;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int k = i % K, p = i / K;
    dst[i] = py[(p / W) * K + k] * inv_w + px[(p % W) * K + k] * inv_h;
  }
}

}  // namespace

// heat, dheat (B, H, W, K), dcoords (B, K, 2), dmaps (B, OH, OW, K) or null:
// contiguous f32 on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bottleneck_bwd(const void* heat, const void* dcoords, const void* dmaps,
                              void* dheat, int B, int H, int W, int K, int OH, int OW,
                              float inv_t, float s2, void* stream) {
  const size_t n_out = dmaps != nullptr ? (size_t)OH * OW * K : 0;
  const size_t smem = sizeof(float) * ((size_t)H * W * K + n_out + (size_t)(H + W) * K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bottleneck_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bottleneck_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)heat, (const float*)dcoords, (const float*)dmaps, (float*)dheat,
      H, W, K, OH, OW, inv_t, s2);
  return (int)cudaGetLastError();
}
