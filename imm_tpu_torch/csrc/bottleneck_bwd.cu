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
// What bounds it: not the bytes. At the training shape (128, 16, 16, 10) it
// moves 3.94 MB (heatmaps, dmaps and dcoords in, dH out), about 1.2 us at
// 3.35 TB/s, but the launch is 128 blocks, one to an SM, and each block is a
// chain of dependent steps (load, reduce, expf, reduce, expf, reduce, write)
// with nothing beside it on its SM to overlap: the kernel takes as long as
// one block's chain. The design keeps that chain short and runs it once
// whatever K is.
//   - One block per image, one warp per landmark (32 * K threads, at most 32
//     warps, which then take several landmarks each), so every landmark goes
//     through the chain at the same time.
//   - The heatmap and the dmaps tile leave device memory once, as 16-byte
//     loads, and are stored in shared memory landmark-major, (K, H, W) with
//     odd row and plane pitches, so that a warp reads its own landmark's
//     plane without bank conflicts along rows and along columns.
//   - For H, W <= 16 the lower half-warp takes the y marginal (lane i sums
//     row i), the upper the x marginal (lane j sums column j), and the two
//     softmaxes run at once, each with three 4-step shuffle reductions that
//     stay inside a half-warp; p never leaves registers. Larger maps take
//     strided loops over a whole warp, one axis after the other.
//   - The render reduction is one warp per landmark over the (OH, OW) pixels;
//     dcoords is loaded before the chain and used at its end.
//   - One barrier, then dH is written in NHWC order with 16-byte stores.
// Nothing is kept from the forward but the heatmaps: recomputing p, c and M
// costs less than five residual tensors through device memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

// i * (2 / (n - 1)) - 1, as the Pallas kernel builds its ruler
// (fused.py:_ruler); n == 1 gives -1, as linspace(-1, 1, 1) does.
__device__ __forceinline__ float ruler(int i, int n) {
  return n > 1 ? i * (2.0f / (n - 1)) - 1.0f : -1.0f;
}

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

// Copies the pixel-major (P, K) array `src` of n = P * K values into `dst`
// landmark-major: value (p, k) goes to dst[k * plane + (p / cols) * pitch +
// p % cols]. kVec is 4 (16-byte loads; n a multiple of 4, src aligned) or 1.
template <int kVec>
__device__ __forceinline__ void stage_landmark_major(const float* __restrict__ src,
                                                     float* __restrict__ dst, int n, int K,
                                                     int cols, int pitch, int plane) {
  for (int i = threadIdx.x * kVec; i < n; i += blockDim.x * kVec) {
    float v[kVec];
    if constexpr (kVec == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      v[0] = src[i];
    }
    const int p = i / K;
    int k = i - p * K, r = p / cols, c = p - r * cols;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      dst[k * plane + r * pitch + c] = v[j];
      if (++k == K) {
        k = 0;
        if (++c == cols) c = 0, ++r;
      }
    }
  }
}

// dH (H, W, K) of one image from dz_y (H, K) and dz_x (W, K), in NHWC order.
template <int kVec>
__device__ __forceinline__ void write_dheat(float* __restrict__ dst, const float* dzy,
                                            const float* dzx, int H, int W, int K) {
  const float inv_w = 1.0f / W, inv_h = 1.0f / H;
  for (int i = threadIdx.x * kVec; i < H * W * K; i += blockDim.x * kVec) {
    const int px = i / K;
    int k = i - px * K, h = px / W, w = px - h * W;
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = dzy[h * K + k] * inv_w + dzx[w * K + k] * inv_h;
      if (++k == K) {
        k = 0;
        if (++w == W) w = 0, ++h;
      }
    }
    if constexpr (kVec == 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
    else
      dst[i] = v[0];
  }
}

// One warp, the strided route: marg[i * K + k] (the mean marginal) becomes
// softmax_i(marg * inv_t) in place; returns its expectation against the ruler.
__device__ float softmax_in_place(float* marg, int n, int K, int k, float inv_t, int lane) {
  float m = -CUDART_INF_F;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, marg[i * K + k] * inv_t);
  m = lanes_max<5>(m);
  float se = 0.0f, unused = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(marg[i * K + k] * inv_t - m);
    marg[i * K + k] = e;
    se += e;
  }
  lanes_sum2<5>(se, unused);
  float c = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float p = marg[i * K + k] / se;
    marg[i * K + k] = p;
    c += p * ruler(i, n);
  }
  lanes_sum2<5>(c, unused);
  return c;
}

// kHalfWarps: H, W <= 16, a half-warp per axis. kVec: 4 where every tile is a
// whole number of aligned 16-byte groups, else 1.
template <bool kHalfWarps, int kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
bottleneck_bwd_kernel(const float* __restrict__ heat, const float* __restrict__ dcoords,
                      const float* __restrict__ dmaps, float* __restrict__ dheat,
                      int H, int W, int K, int OH, int OW, float inv_t, float s2) {
  extern __shared__ float smem[];
  const int n_in = H * W * K, n_px = OH * OW;
  const int pitch = W | 1, plane = (H * pitch) | 1, plane_out = n_px | 1;
  const bool render = dmaps != nullptr;
  float* tile = smem;                            // (K, H, W): plane, pitch
  float* dm = tile + K * plane;                  // (K, OH * OW): plane_out, if any
  float* dzy = dm + (render ? K * plane_out : 0);  // (H, K): dz_y
  float* dzx = dzy + H * K;                      // (W, K): dz_x
  const size_t b = blockIdx.x;

  stage_landmark_major<kVec>(heat + b * n_in, tile, n_in, K, W, pitch, plane);
  if (render)
    stage_landmark_major<kVec>(dmaps + b * n_px * K, dm, n_px * K, K, n_px, 0, plane_out);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += blockDim.x >> 5) {
    // needed at the chain's end: in flight while the softmaxes run
    const float2 dc = reinterpret_cast<const float2*>(dcoords)[b * K + k];
    const float* t = tile + k * plane;
    float cy, cx, p = 0.0f;
    const int upper = lane >> 4, j = lane & 15;  // the half-warp route's axis and index
    if (kHalfWarps) {
      // lower half: row j along x; upper half: column j along y
      const int n = upper ? W : H, terms = upper ? H : W;
      const int first = upper ? j : j * pitch, stride = upper ? pitch : 1;
      const bool active = j < n;
      float s = 0.0f;
      if (active)
        for (int q = 0; q < terms; ++q) s += t[first + q * stride];
      const float z = active ? s / terms * inv_t : -CUDART_INF_F;
      const float m = lanes_max<4>(z);  // finite: lane 0 of each half is active
      const float e = active ? expf(z - m) : 0.0f;
      float se = e, sc = e * ruler(j, n);
      lanes_sum2<4>(se, sc);
      p = e / se;
      const float c = sc / se;
      cy = __shfl_sync(kFull, c, 0);
      cx = __shfl_sync(kFull, c, 16);
    } else {
      for (int i = lane; i < H; i += 32) {
        float s = 0.0f;
        for (int w = 0; w < W; ++w) s += t[i * pitch + w];
        dzy[i * K + k] = s / W;
      }
      for (int i = lane; i < W; i += 32) {
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s += t[h * pitch + i];
        dzx[i * K + k] = s / H;
      }
      // each lane reads and writes only its own entries between the shuffles
      cy = softmax_in_place(dzy, H, K, k, inv_t, lane);
      cx = softmax_in_place(dzx, W, K, k, inv_t, lane);
    }

    float ay = 0.0f, ax = 0.0f;
    if (render) {
      const float* d = dm + k * plane_out;
      int oy = lane / OW, ox = lane - oy * OW;
      for (int q = lane; q < n_px; q += 32) {
        const float gy = ruler(oy, OH) - cy, gx = ruler(ox, OW) - cx;
        const float wgt = d[q] * expf(-((gy * gy + gx * gx) * s2)) * (2.0f * s2);
        ay += wgt * gy;
        ax += wgt * gx;
        for (ox += 32; ox >= OW; ox -= OW) ++oy;
      }
      lanes_sum2<5>(ay, ax);
    }
    const float dcy = (dc.x + ay) * inv_t, dcx = (dc.y + ax) * inv_t;
    if (kHalfWarps) {
      if (j < (upper ? W : H))
        (upper ? dzx : dzy)[j * K + k] =
            p * (ruler(j, upper ? W : H) - (upper ? cx : cy)) * (upper ? dcx : dcy);
    } else {
      for (int i = lane; i < H; i += 32) dzy[i * K + k] *= (ruler(i, H) - cy) * dcy;
      for (int i = lane; i < W; i += 32) dzx[i * K + k] *= (ruler(i, W) - cx) * dcx;
    }
  }
  __syncthreads();

  write_dheat<kVec>(dheat + b * n_in, dzy, dzx, H, W, K);
}

template <bool kHalfWarps, int kVec>
int launch(const float* heat, const float* dcoords, const float* dmaps, float* dheat, int B,
           int H, int W, int K, int OH, int OW, float inv_t, float s2, cudaStream_t stream) {
  const size_t plane = (size_t)(H * (W | 1)) | 1, plane_out = (size_t)(OH * OW) | 1;
  const size_t smem = sizeof(float) * (K * plane + (dmaps != nullptr ? K * plane_out : 0) +
                                       (size_t)(H + W) * K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bottleneck_bwd_kernel<kHalfWarps, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = K < kMaxWarps ? K : kMaxWarps;
  bottleneck_bwd_kernel<kHalfWarps, kVec><<<B, 32 * warps, smem, stream>>>(
      heat, dcoords, dmaps, dheat, H, W, K, OH, OW, inv_t, s2);
  return (int)cudaGetLastError();
}

}  // namespace

// heat, dheat (B, H, W, K), dcoords (B, K, 2), dmaps (B, OH, OW, K) or null:
// contiguous f32 on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bottleneck_bwd(const void* heat, const void* dcoords, const void* dmaps,
                              void* dheat, int B, int H, int W, int K, int OH, int OW,
                              float inv_t, float s2, void* stream) {
  const auto aligned = [](const void* p) { return ((size_t)p & 15) == 0; };
  const bool vec = (H * W * K) % 4 == 0 && aligned(heat) && aligned(dheat) &&
                   (dmaps == nullptr || ((OH * OW * K) % 4 == 0 && aligned(dmaps)));
  const bool half_warps = H <= 16 && W <= 16;
  using Launch = int (*)(const float*, const float*, const float*, float*, int, int, int, int,
                         int, int, float, float, cudaStream_t);
  const Launch fn[2][2] = {{launch<false, 1>, launch<false, 4>},
                           {launch<true, 1>, launch<true, 4>}};
  return fn[half_warps][vec]((const float*)heat, (const float*)dcoords, (const float*)dmaps, (float*)dheat, B, H,
            W, K, OH, OW, inv_t, s2, (cudaStream_t)stream);
}
