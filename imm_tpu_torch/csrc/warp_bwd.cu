// Batched bilinear warp backward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/warp_pallas.py:_warp_bwd_kernel, the Pallas TPU kernel
// launched by _warp_pallas_bwd. For the resample of warp_fwd.cu and a
// cotangent g (B, Ho, Wo, C) it produces
//   d_images (B, H, W, C) f32: the transpose of the lerp, each output pixel's
//     g scattered to its four source pixels with the lerp weights;
//   d_fy, d_fx (B, Ho, Wo) f32: the cotangent of the clipped pixel
//     coordinates, summed over channels,
//       d_fy = sum_c g * (lerp_x(v[y1]) - lerp_x(v[y0])),
//       d_fx = sum_c g * (lerp_y(v[:, x1]) - lerp_y(v[:, x0])),
//     which is 0 where the upper neighbour is clamped onto the lower one.
// The clip's own gradient (0.5 at an exact tie) and the [-1, 1] -> pixel
// scale are chained outside the kernel, as the Pallas wrapper does.
//
// The TPU kernel writes the scatter as a dense matrix product against one-hot
// masks; here it is a direct scatter. What bounds it: device-memory bytes
// (images, grid and cotangent in, d_images, d_fy, d_fx out: 109 MB at
// (128, 128, 128, 3) f32, about 33 us at 3.35 TB/s), and then the atomics'
// rate. Design: one thread per output pixel covering all C channels, the
// same coordinates as the forward; d_images is accumulated with atomicAdd
// into an f32 buffer that the wrapper zeroes first. Atomics and not a
// gather-form transpose: the transpose would have each source pixel search
// the grid for the output pixels that read it, which for an arbitrary warp
// is a sort, while the scatter is one pass and a smooth warp spreads the
// atomics over distinct addresses (four per thread and channel, resolved in
// L2). The price is a summation order that varies from run to run: d_images
// is reproducible to a few f32 units in the last place of the largest
// partial sum only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// As in warp_fwd.cu: [-1, 1] -> pixel units, clipped to [0, n - 1].
__device__ __forceinline__ float pixel(float g, int n) {
  const float f = (g + 1.0f) * 0.5f * (float)(n - 1);
  return fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const T* __restrict__ img, const float2* __restrict__ grid,
                const T* __restrict__ cot, float* __restrict__ dimg,
                float* __restrict__ dfy, float* __restrict__ dfx, int H, int W, int C,
                long long Q, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float2 g = grid[i];  // .x holds y, .y holds x
  const float fy = pixel(g.x, H), fx = pixel(g.y, W);
  const float y0f = floorf(fy), x0f = floorf(fx);
  const float wy = fy - y0f, wx = fx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);

  const long long image = (i / Q) * H * W * C;
  const long long o00 = image + ((long long)y0 * W + x0) * C;
  const long long o01 = image + ((long long)y0 * W + x1) * C;
  const long long o10 = image + ((long long)y1 * W + x0) * C;
  const long long o11 = image + ((long long)y1 * W + x1) * C;
  const T* gc = cot + i * C;
  float sy = 0.0f, sx = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float gv = load(gc + c);
    const float v00 = load(img + o00 + c), v01 = load(img + o01 + c);
    const float v10 = load(img + o10 + c), v11 = load(img + o11 + c);
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    const float left = v00 * (1.0f - wy) + v10 * wy;
    const float right = v01 * (1.0f - wy) + v11 * wy;
    sy += gv * (bot - top);
    sx += gv * (right - left);
    atomicAdd(dimg + o00 + c, gv * (1.0f - wy) * (1.0f - wx));
    atomicAdd(dimg + o01 + c, gv * (1.0f - wy) * wx);
    atomicAdd(dimg + o10 + c, gv * wy * (1.0f - wx));
    atomicAdd(dimg + o11 + c, gv * wy * wx);
  }
  dfy[i] = sy;
  dfx[i] = sx;
}

}  // namespace

// img (B, H, W, C) and cot (B, Ho, Wo, C) in f32 or bf16 (is_bf16), grid
// (B, Ho, Wo, 2) f32, dimg (B, H, W, C) f32 zeroed by the caller, dfy and dfx
// (B, Ho, Wo) f32: contiguous on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int warp_bwd(const void* img, const void* grid, const void* cot, void* dimg,
                        void* dfy, void* dfx, int B, int H, int W, int C, int Ho, int Wo,
                        int is_bf16, void* stream) {
  const long long q = (long long)Ho * Wo, total = q * B;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float2*)grid, (const __nv_bfloat16*)cot,
        (float*)dimg, (float*)dfy, (float*)dfx, H, W, C, q, total);
  } else {
    warp_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)img, (const float2*)grid, (const float*)cot, (float*)dimg,
        (float*)dfy, (float*)dfx, H, W, C, q, total);
  }
  return (int)cudaGetLastError();
}
