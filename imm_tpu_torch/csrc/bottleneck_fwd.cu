// Fused landmark bottleneck forward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/fused.py:_bottleneck_kernel, the Pallas TPU kernel
// launched by _bottleneck_pallas_fwd. Per image b of (B, H, W, K) f32
// heatmaps: the y and x marginal means, a softmax at temperature T over each
// axis and the expectation against the [-1, 1] ruler give coords (B, K, 2) in
// (y, x) order; then the 'rot' Gaussian exp(-s^2((ry-cy)^2 + (rx-cx)^2)) is
// rendered to (B, OH, OW, K), channel-last.
//
// What bounds it: not the bytes. At the serving shape (128, 16, 16, 10) it
// moves 2.6 MB, about 0.8 us at 3.35 TB/s, but the launch is 128 blocks, one
// to an SM, and each block is a chain of dependent steps (load, reduce, expf,
// reduce, expf, write) with nothing beside it on its SM to overlap: the
// kernel takes as long as one block's chain. The design, the same as
// bottleneck_bwd.cu's, keeps that chain short and runs it once whatever K is.
//   - One block per image, one warp per landmark (32 * K threads, at most 32
//     warps, which then take several landmarks each), so every landmark goes
//     through the chain at the same time.
//   - The heatmap leaves device memory once, as 16-byte loads, and is stored
//     in shared memory landmark-major, (K, H, W) with odd row and plane
//     pitches, so that a warp reads its own landmark's plane without bank
//     conflicts along rows and along columns.
//   - For H, W <= 16 the lower half-warp takes the y marginal (lane i sums
//     row i), the upper the x marginal (lane j sums column j), and the two
//     softmaxes run at once: one 4-step max and one 4-step reduction that
//     carries the sum and the ruler-weighted sum together, inside a
//     half-warp. The marginals never leave registers. Larger maps take
//     strided loops over a whole warp, one axis after the other.
//   - The render is separable: exp(-s^2 (dy^2 + dx^2)) is the product of a
//     factor per output row and a factor per output column. The warp that
//     knows (cy, cx) computes these OH + OW factors, one expf a lane, and
//     leaves them in shared memory; after one barrier every thread writes the
//     maps in NHWC order with 16-byte stores, one product per value. The
//     product is within a few units in the last place of the exp of the sum.
//   - A lone block gains from every instruction it does not run. The host
//     hands over what depends on the shape alone: the rulers' steps, and the
//     three divisors of the index arithmetic as fixed-point reciprocals (an
//     integer division by a run-time number costs about 150 cycles, and a
//     thread did eight). The half-warp sums load without a condition, all
//     loads before the first add, and the index steps are selects, not
//     branches.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

// n / d for 0 <= n < 2^31 as a multiplication by d's reciprocal in fixed
// point: with shift = 31 + ceil(log2(d)), mul = ceil(2^shift / d) fits 32 bits
// and (n * mul) >> shift is exact (mul * d - 2^shift < d <= 2^(shift - 31)).
struct Divisor {
  unsigned mul;
  int shift;
};

Divisor divisor(int d) {
  d = d > 1 ? d : 1;  // an empty axis is never divided by
  int bits = 0;
  while ((1u << bits) < (unsigned)d) ++bits;
  const int shift = 31 + bits;
  return {(unsigned)(((1ull << shift) + d - 1) / d), shift};
}

__device__ __forceinline__ int quotient(int n, Divisor v) {
  return (int)(((unsigned long long)(unsigned)n * v.mul) >> v.shift);
}

// What one launch knows of its shape before it starts.
struct Shape {
  int H, W, K, OH, OW;
  float inv_t, s2;
  float step_h, step_w, step_oh, step_ow;  // the rulers' steps
  Divisor by_k, by_w, by_ow;
};

// The ruler is i * (2 / (n - 1)) - 1, as the Pallas kernel builds it
// (fused.py:_ruler); n == 1 gives -1, as linspace(-1, 1, 1) does. The step is
// the host's float division, the same IEEE operation as the device's.
float ruler_step(int n) { return n > 1 ? 2.0f / (n - 1) : 0.0f; }

__device__ __forceinline__ float ruler(int i, float step) { return i * step - 1.0f; }

// Reductions over the 32 >> (5 - kSteps) lanes that differ in their low
// kSteps bits: a whole warp (5) or each half-warp apart (4).
template <int kSteps>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = 1 << (kSteps - 1); o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int kSteps>
__device__ __forceinline__ void lanes_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 1 << (kSteps - 1); o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
}

// (k, x, y) -> the next value in (y, x, k) order, where x runs to `cols`.
__device__ __forceinline__ void next_value(int& k, int& x, int& y, int K, int cols) {
  const bool next_px = ++k == K;
  k = next_px ? 0 : k;
  x += next_px;
  const bool next_row = x == cols;
  x = next_row ? 0 : x;
  y += next_row;
}

// Copies the pixel-major (H * W, K) heatmap `src` into `dst` landmark-major:
// value (h, w, k) goes to dst[k * plane + h * pitch + w]. kVec is 4 (16-byte
// loads; H * W * K a multiple of 4, src aligned) or 1.
template <int kVec>
__device__ __forceinline__ void stage_landmark_major(const float* __restrict__ src,
                                                     float* __restrict__ dst, const Shape& g,
                                                     int pitch, int plane) {
  for (int i = threadIdx.x * kVec; i < g.H * g.W * g.K; i += blockDim.x * kVec) {
    float v[kVec];
    if constexpr (kVec == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      v[0] = src[i];
    }
    const int p = quotient(i, g.by_k);
    int k = i - p * g.K, h = quotient(p, g.by_w), w = p - h * g.W;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      dst[k * plane + h * pitch + w] = v[j];
      next_value(k, w, h, g.K, g.W);
    }
  }
}

// The maps (OH, OW, K) of one image in NHWC order from the row factors
// fy (OH, K) and the column factors fx (OW, K).
template <int kVec>
__device__ __forceinline__ void write_maps(float* __restrict__ dst, const float* fy,
                                           const float* fx, const Shape& g) {
  for (int i = threadIdx.x * kVec; i < g.OH * g.OW * g.K; i += blockDim.x * kVec) {
    const int px = quotient(i, g.by_k);
    int k = i - px * g.K, oy = quotient(px, g.by_ow), ox = px - oy * g.OW;
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = fy[oy * g.K + k] * fx[ox * g.K + k];
      next_value(k, ox, oy, g.K, g.OW);
    }
    if constexpr (kVec == 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
    else
      dst[i] = v[0];
  }
}

// One warp, the strided route: softmax over i of marg[i * K + k] * inv_t,
// then its expectation against the ruler of n entries, on every lane.
__device__ float softmax_expectation(const float* marg, int n, float step, int K, int k,
                                     float inv_t, int lane) {
  float m = -CUDART_INF_F;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, marg[i * K + k] * inv_t);
  m = lanes_max<5>(m);
  float se = 0.0f, sc = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(marg[i * K + k] * inv_t - m);
    se += e;
    sc += e * ruler(i, step);
  }
  lanes_sum2<5>(se, sc);
  return sc / se;
}

// kHalfWarps: H, W <= 16, a half-warp per axis. kVec: 4 where the heatmap and
// the maps of an image are whole numbers of aligned 16-byte groups, else 1.
template <bool kHalfWarps, int kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
bottleneck_fwd_kernel(const float* __restrict__ heat, float* __restrict__ coords,
                      float* __restrict__ maps, const __grid_constant__ Shape g) {
  extern __shared__ float smem[];
  const int H = g.H, W = g.W, K = g.K, OH = g.OH, OW = g.OW;
  const int pitch = W | 1, plane = (H * pitch) | 1;
  float* tile = smem;                 // (K, H, W): plane, pitch
  float* fac = tile + K * plane;      // (OH + OW, K): row factors, then column factors
  float* marg = fac + (OH + OW) * K;  // (H + W, K): the strided route's mean marginals
  const size_t b = blockIdx.x;

  stage_landmark_major<kVec>(heat + b * H * W * K, tile, g, pitch, plane);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += blockDim.x >> 5) {
    const float* t = tile + k * plane;
    float cy, cx;
    if (kHalfWarps) {
      // lower half: lane j sums row j along x; upper half: column j along y
      const int upper = lane >> 4, j = lane & 15;
      const int n = upper ? W : H, terms = upper ? H : W;
      const int stride = upper ? pitch : 1;
      const bool active = j < n;
      // Loads without a condition, all before the sum: an idle lane repeats
      // the last line, a term past the end the last term, and neither counts.
      const int line = max(min(j, n - 1), 0), last = max(terms - 1, 0);
      const float* src = t + (upper ? line : line * pitch);
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] = src[min(q, last) * stride];
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 16; ++q) s += q < terms ? v[q] : 0.0f;
      const float z = active ? s / terms * g.inv_t : -CUDART_INF_F;
      const float m = lanes_max<4>(z);  // finite: lane 0 of each half is active
      const float e = active ? expf(z - m) : 0.0f;
      float se = e, sc = e * ruler(j, upper ? g.step_w : g.step_h);
      lanes_sum2<4>(se, sc);
      const float c = sc / se;
      cy = __shfl_sync(kFull, c, 0);
      cx = __shfl_sync(kFull, c, 16);
    } else {
      for (int i = lane; i < H; i += 32) {
        float s = 0.0f;
        for (int w = 0; w < W; ++w) s += t[i * pitch + w];
        marg[i * K + k] = s / W;
      }
      for (int i = lane; i < W; i += 32) {
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s += t[h * pitch + i];
        marg[(H + i) * K + k] = s / H;
      }
      // each lane reads only the entries it wrote
      cy = softmax_expectation(marg, H, g.step_h, K, k, g.inv_t, lane);
      cx = softmax_expectation(marg + H * K, W, g.step_w, K, k, g.inv_t, lane);
    }
    if (lane == 0) reinterpret_cast<float2*>(coords)[b * K + k] = make_float2(cy, cx);
    for (int i = lane; i < OH + OW; i += 32) {
      const float d = i < OH ? ruler(i, g.step_oh) - cy : ruler(i - OH, g.step_ow) - cx;
      fac[i * K + k] = expf(-(d * d * g.s2));
    }
  }
  __syncthreads();

  write_maps<kVec>(maps + b * OH * OW * K, fac, fac + OH * K, g);
}

template <bool kHalfWarps, int kVec>
int launch(const float* heat, float* coords, float* maps, int B, const Shape& g,
           cudaStream_t stream) {
  const int H = g.H, W = g.W, K = g.K, OH = g.OH, OW = g.OW;
  const size_t plane = (size_t)(H * (W | 1)) | 1;
  const size_t smem = sizeof(float) * K * (plane + OH + OW + H + W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bottleneck_fwd_kernel<kHalfWarps, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = K < kMaxWarps ? K : kMaxWarps;
  bottleneck_fwd_kernel<kHalfWarps, kVec><<<B, 32 * warps, smem, stream>>>(heat, coords, maps, g);
  return (int)cudaGetLastError();
}

}  // namespace

// heat (B, H, W, K), coords (B, K, 2), maps (B, OH, OW, K): contiguous f32 on
// the device. Launches on `stream` and returns cudaGetLastError().
extern "C" int bottleneck_fwd(const void* heat, void* coords, void* maps, int B,
                              int H, int W, int K, int OH, int OW, float inv_t,
                              float s2, void* stream) {
  const Shape g = {H, W, K, OH, OW, inv_t, s2,
                   ruler_step(H), ruler_step(W), ruler_step(OH), ruler_step(OW),
                   divisor(K), divisor(W), divisor(OW)};
  const auto aligned = [](const void* p) { return ((size_t)p & 15) == 0; };
  const bool vec = (H * W * K) % 4 == 0 && (OH * OW * K) % 4 == 0 && aligned(heat) && aligned(maps);
  const bool half_warps = H <= 16 && W <= 16;
  using Launch = int (*)(const float*, float*, float*, int, const Shape&, cudaStream_t);
  const Launch fn[2][2] = {{launch<false, 1>, launch<false, 4>},
                           {launch<true, 1>, launch<true, 4>}};
  return fn[half_warps][vec]((const float*)heat, (float*)coords, (float*)maps, B, g,
                             (cudaStream_t)stream);
}
