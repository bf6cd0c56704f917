// Train-mode BatchNorm and the ReLU after it for Hopper (sm_90a), forward
// and backward (K5).
//
// Replaces no Pallas kernel: on the TPU, XLA fused flax's BatchNorm into the
// ops around it. PyTorch ran it as ~18 generic launches a block forward and
// again backward, each a pass over an f32 copy of the activations.
//
// Over x (N, C, H, W) in bf16 or f32, statistics per channel over N, H, W,
// with flax's conventions (biased variance, eps; momentum for the running
// statistics), a = gamma * invstd:
//   forward   mean, var;  invstd = rsqrt(var + eps)
//             y = relu((x - mean) * a + beta)                 (relu optional)
//   backward  g = dy * [(x - mean) * a + beta > 0],  xhat = (x - mean) * invstd
//             dbeta = sum g,  dgamma = sum g * xhat
//             dx = a * (g - dbeta / n - xhat * dgamma / n)
// The backward keeps nothing of the forward but x, mean and invstd: it
// recomputes the ReLU's mask from x with the forward's operations, bit for
// bit.
//
// What bounds it: device-memory bytes. Each of the four passes reads or
// writes each activation once, 16 bytes an element in bf16 over all four
// (forward 2 + 4, backward 4 + 6), against a few f32 operations. Design:
//   - Channels-last (C innermost, what the model's convolutions hand over)
//     is the main layout. A thread owns 8 consecutive channels of a row, one
//     16-byte load in bf16, and walks rows, 4 at a time so that 4 loads are
//     in flight. A block of 256 threads covers a group of up to 64 channels
//     (8 lanes) of 32 or more rows, so a warp reads whole 128-byte lines.
//     NCHW-contiguous is taken too: a block owns one channel and walks its
//     planes, 8 elements a load where a plane is a whole number of 16-byte
//     groups.
//   - The grid holds about 4 blocks an SM whatever the layer, the blocks of
//     a channel group taking rows in turn, so the 16 x 16 x 256 layers fill
//     the card as the 128 x 128 x 32 ones do. The backward's kernels, which
//     hold x and dy of 4 rows and 5 constants a channel, are held to 128
//     registers so that 2 blocks share an SM (154 registers left room for
//     1; 128 read 2-8% faster on the H100).
//   - A reduction (the statistics forward, the two sums backward) is one
//     launch: each block writes one partial a channel of its group, and the
//     group's last block to finish (a counter that atomicInc wraps back to
//     0 for the next launch) adds the group's partials in a fixed order and
//     finishes the channel: mean and invstd, with the running statistics
//     updated in place; or dgamma and dbeta. Every sum is taken in one order,
//     so the results repeat bit for bit.
//   - The statistics are sums of x - k and (x - k)^2, k the channel's value
//     in the first row: a shift inside the data keeps the variance to a
//     two-pass one's quality where the mean is large against the spread, and
//     the partials merge by addition.
//   - With axis_name (data parallel) the statistics pass stops at the local
//     (mean, E[x^2]), the caller all-reduces them, and a one-block launch
//     takes the global pair (var = E[x^2] - E[x]^2, clipped at 0, as flax).
//     The backward likewise stops after its sums, and the elementwise pass
//     takes their global means.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows a thread has in flight
constexpr int kVec = 8;     // values a thread loads at once

// the entry points' stages (besides 0: the whole pass) and flags, as
// ops/batchnorm.py passes them
constexpr int kStatsOnly = 1, kApplyOnly = 2;
constexpr int kUpdateStats = 1, kRelu = 2, kFlaxVariance = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// max(v, 0) that keeps a NaN, as torch.relu and torch.clamp do
__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// N consecutive values; N == kVec: one (bf16) or two (f32) 16-byte accesses,
// the address 16-byte aligned.
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, float (&v)[N]) {
  if constexpr (N == kVec) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[N]) {
  if constexpr (N == kVec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p, const float (&v)[N]) {
  if constexpr (N == kVec) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) put(p + i, v[i]);
  }
}

template <int N>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[N]) {
  if constexpr (N == kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) put(p + i, v[i]);
  }
}

// A block's threads are (tx, ty), thread index ty * L + tx, tx < L, and
// those with ty < P hold rows. Each holds v[kN]; afterwards the threads with
// ty == 0 hold the sums over ty, added in a fixed order. sh: kN * kThreads.
template <int kN>
__device__ __forceinline__ void sum_over_rows(float (&v)[kN], float* sh, int L, int P) {
  const int t = threadIdx.x, ty = t / L;
#pragma unroll
  for (int i = 0; i < kN; ++i) sh[i * kThreads + t] = v[i];
  __syncthreads();
  int top = 1;
  while (top < P) top <<= 1;
  for (int s = top >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < P) {
#pragma unroll
      for (int i = 0; i < kN; ++i) sh[i * kThreads + t] += sh[i * kThreads + t + s * L];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = sh[i * kThreads + t];
  __syncthreads();
}

// Called by every thread once its block's partials are written: true in the
// last block of its group (blockIdx.y) to get here. The counter wraps back
// to 0, ready for the next launch.
__device__ __forceinline__ bool last_of_group(unsigned* counters) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(counters + blockIdx.y, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// In the last block of a group: the totals over the gridDim.x blocks of the
// two partials (part[g * C + c], part[(gridDim.x + g) * C + c]) of the CG
// channels from `first`, in a fixed order. The block's threads split the
// blocks' partials between them, each with kMerge loads in flight: one
// thread walking all of them in turn would wait on the L2 for each (~50 us
// at 528 blocks). Returns the channel whose totals the thread holds, or -1.
__device__ __forceinline__ int merge_partials(const float* part, int C, int first, int CG,
                                              float (&tot)[2], float* sh) {
  constexpr int kMerge = 8;
  const int gx = gridDim.x, GL = kThreads / CG, cl = threadIdx.x % CG, gl = threadIdx.x / CG;
  const float* p0 = part + first + cl;
  const float* p1 = p0 + (size_t)gx * C;
  float acc[kMerge][2] = {};
  int g = gl;
  if (gl < GL) {
    for (; g + (kMerge - 1) * GL < gx; g += kMerge * GL) {
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        acc[u][0] += __ldcg(p0 + (size_t)(g + u * GL) * C);
        acc[u][1] += __ldcg(p1 + (size_t)(g + u * GL) * C);
      }
    }
    for (; g < gx; g += GL) {
      acc[0][0] += __ldcg(p0 + (size_t)g * C);
      acc[0][1] += __ldcg(p1 + (size_t)g * C);
    }
  }
  tot[0] = tot[1] = 0.0f;
#pragma unroll
  for (int u = 0; u < kMerge; ++u) tot[0] += acc[u][0], tot[1] += acc[u][1];
  sum_over_rows<2>(tot, sh, CG, GL);
  return gl == 0 ? first + cl : -1;
}

// A block's partials of its channels c0 .. c0 + kN: sums[0 .. kN) and
// sums[kN .. 2 kN).
template <int kN>
__device__ __forceinline__ void write_partials(float* part, int C, int c0, const float (&sums)[2 * kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    part[(size_t)blockIdx.x * C + c0 + j] = sums[j];
    part[((size_t)gridDim.x + blockIdx.x) * C + c0 + j] = sums[kN + j];
  }
}

// Where the forward's statistics go and how a channel is finished.
struct Stats {
  float* out;  // (2, C): mean; invstd, or E[x^2] while local
  float* running_mean;
  float* running_var;
  int C, flags, local;
  float momentum, rest, eps;  // rest: 1 - momentum, as the caller rounds it

  __device__ void finish(int c, float mean, float var) const {
    out[c] = mean;
    out[C + c] = rsqrtf(var + eps);
    if (flags & kUpdateStats) {  // running = running * momentum + rest * batch
      running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], momentum), __fmul_rn(rest, mean));
      running_var[c] = __fadd_rn(__fmul_rn(running_var[c], momentum), __fmul_rn(rest, var));
    }
  }

  // from the sums of x - k and (x - k)^2 over the channel's n values
  __device__ void from_sums(int c, float k, float s1, float s2, float inv_n) const {
    const float d = s1 * inv_n, mean = k + d;
    const float var = clamp0(s2 * inv_n - d * d);
    const float mean_sq = __fadd_rn(var, __fmul_rn(mean, mean));
    if (local) {
      out[c] = mean;
      out[C + c] = mean_sq;
    } else {
      finish(c, mean, (flags & kFlaxVariance) ? clamp0(__fsub_rn(mean_sq, __fmul_rn(mean, mean))) : var);
    }
  }
};

// Per channel: the forward's mean, a = gamma * invstd and beta, as both
// passes compute them.
struct Affine {
  float mean, invstd, a, beta;
  __device__ float operator()(float xm) const { return fmaf(xm, a, beta); }  // xm = x - mean
};

__device__ __forceinline__ Affine affine(const float* stats, const float* w, const float* b, int C,
                                         int c) {
  return Affine{stats[c], stats[C + c], __fmul_rn(w[c], stats[C + c]), b[c]};
}

// ---- forward ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_cl(const T* __restrict__ x, long long rows, int C, int L, float inv_n, float* part,
         unsigned* counters, Stats fin) {
  __shared__ float sh[2 * kVec * kThreads];
  const int P = kThreads / L, tx = threadIdx.x % L, ty = threadIdx.x / L;
  const int c0 = (blockIdx.y * L + tx) * kVec;
  float v[2 * kVec] = {};  // sums of x - k, then of (x - k)^2
  if (ty < P) {
    float k[kVec];
    load<kVec>(x + c0, k);
    const long long step = (long long)gridDim.x * P;
    long long r = (long long)blockIdx.x * P + ty;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float q[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<kVec>(x + (r + u * step) * C + c0, q[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = q[u][j] - k[j];
          v[j] += d;
          v[kVec + j] = fmaf(d, d, v[kVec + j]);
        }
      }
    }
    for (; r < rows; r += step) {
      float q[kVec];
      load<kVec>(x + r * C + c0, q);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = q[j] - k[j];
        v[j] += d;
        v[kVec + j] = fmaf(d, d, v[kVec + j]);
      }
    }
  }
  sum_over_rows<2 * kVec>(v, sh, L, P);
  if (ty == 0) write_partials<kVec>(part, C, c0, v);
  if (!last_of_group(counters)) return;
  float tot[2];
  const int c = merge_partials(part, C, blockIdx.y * L * kVec, L * kVec, tot, sh);
  if (c >= 0) fin.from_sums(c, to_f(x[c]), tot[0], tot[1], inv_n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_apply_cl(const T* __restrict__ x, T* __restrict__ y, long long rows, int C, int L,
         const float* __restrict__ stats, const float* __restrict__ w,
         const float* __restrict__ b, int relu) {
  const int P = kThreads / L, tx = threadIdx.x % L, ty = threadIdx.x / L;
  if (ty >= P) return;
  const int c0 = (blockIdx.y * L + tx) * kVec;
  float mean[kVec], a[kVec], beta[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const Affine f = affine(stats, w, b, C, c0 + j);
    mean[j] = f.mean, a[j] = f.a, beta[j] = f.beta;
  }
  const long long step = (long long)gridDim.x * P;
  long long r = (long long)blockIdx.x * P + ty;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float q[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<kVec>(x + (r + u * step) * C + c0, q[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float o = fmaf(q[u][j] - mean[j], a[j], beta[j]);
        q[u][j] = relu ? clamp0(o) : o;
      }
      store<kVec>(y + (r + u * step) * C + c0, q[u]);
    }
  }
  for (; r < rows; r += step) {
    float q[kVec];
    load<kVec>(x + r * C + c0, q);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float o = fmaf(q[j] - mean[j], a[j], beta[j]);
      q[j] = relu ? clamp0(o) : o;
    }
    store<kVec>(y + r * C + c0, q);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
bn_stats_cf(const T* __restrict__ x, int n, int C, long long S, float inv_n, float* part,
         unsigned* counters, Stats fin) {
  __shared__ float sh[2 * kThreads];
  const int c = blockIdx.y;
  const float k = to_f(x[(size_t)c * S]);
  float v[2] = {0.0f, 0.0f};
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const T* p = x + ((size_t)i * C + c) * S;
    for (long long s = (long long)threadIdx.x * N; s < S; s += kThreads * N) {
      float q[N];
      load<N>(p + s, q);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = q[j] - k;
        v[0] += d;
        v[1] = fmaf(d, d, v[1]);
      }
    }
  }
  sum_over_rows<2>(v, sh, 1, kThreads);
  if (threadIdx.x == 0) write_partials<1>(part, C, c, v);
  if (!last_of_group(counters)) return;
  float tot[2];
  if (merge_partials(part, C, c, 1, tot, sh) >= 0) fin.from_sums(c, k, tot[0], tot[1], inv_n);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
bn_apply_cf(const T* __restrict__ x, T* __restrict__ y, int n, int C, long long S,
         const float* __restrict__ stats, const float* __restrict__ w,
         const float* __restrict__ b, int relu) {
  const int c = blockIdx.y;
  const Affine f = affine(stats, w, b, C, c);
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t base = ((size_t)i * C + c) * S;
    for (long long s = (long long)threadIdx.x * N; s < S; s += kThreads * N) {
      float q[N];
      load<N>(x + base + s, q);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float o = f(q[j] - f.mean);
        q[j] = relu ? clamp0(o) : o;
      }
      store<N>(y + base + s, q);
    }
  }
}

// With axis_name: the global (mean, E[x^2]) -> (mean, invstd).
__global__ void bn_finish_global(Stats fin) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= fin.C) return;
  const float mean = fin.out[c], mean_sq = fin.out[fin.C + c];
  fin.finish(c, mean, clamp0(__fsub_rn(mean_sq, __fmul_rn(mean, mean))));
}

// ---- backward --------------------------------------------------------------

// dbeta, dgamma from the merged sums of g and g * (x - mean)
struct Grads {
  float* dweight;
  float* dbias;
  const float* stats;
  int C;
  __device__ void finish(int c, float sum_g, float sum_gxm) const {
    dbias[c] = sum_g;
    dweight[c] = sum_gxm * stats[C + c];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_reduce_cl(const T* __restrict__ dy, const T* __restrict__ x, long long rows, int C, int L,
          const float* __restrict__ w, const float* __restrict__ b, int relu, float* part,
          unsigned* counters, Grads out) {
  __shared__ float sh[2 * kVec * kThreads];
  const int P = kThreads / L, tx = threadIdx.x % L, ty = threadIdx.x / L;
  const int c0 = (blockIdx.y * L + tx) * kVec;
  float v[2 * kVec] = {};  // sums of g, then of g * (x - mean)
  if (ty < P) {
    float mean[kVec], a[kVec], beta[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const Affine f = affine(out.stats, w, b, C, c0 + j);
      mean[j] = f.mean, a[j] = f.a, beta[j] = f.beta;
    }
    const long long step = (long long)gridDim.x * P;
    long long r = (long long)blockIdx.x * P + ty;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float q[kUnroll][kVec], e[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load<kVec>(x + (r + u * step) * C + c0, q[u]);
        load<kVec>(dy + (r + u * step) * C + c0, e[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xm = q[u][j] - mean[j];
          const float g = (relu && !(fmaf(xm, a[j], beta[j]) > 0.0f)) ? 0.0f : e[u][j];
          v[j] += g;
          v[kVec + j] = fmaf(g, xm, v[kVec + j]);
        }
      }
    }
    for (; r < rows; r += step) {
      float q[kVec], e[kVec];
      load<kVec>(x + r * C + c0, q);
      load<kVec>(dy + r * C + c0, e);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xm = q[j] - mean[j];
        const float g = (relu && !(fmaf(xm, a[j], beta[j]) > 0.0f)) ? 0.0f : e[j];
        v[j] += g;
        v[kVec + j] = fmaf(g, xm, v[kVec + j]);
      }
    }
  }
  sum_over_rows<2 * kVec>(v, sh, L, P);
  if (ty == 0) write_partials<kVec>(part, C, c0, v);
  if (!last_of_group(counters)) return;
  float tot[2];
  const int c = merge_partials(part, C, blockIdx.y * L * kVec, L * kVec, tot, sh);
  if (c >= 0) out.finish(c, tot[0], tot[1]);
}

// Per channel of the elementwise pass: dx = a g - c1 - c2 (x - mean), with
// c1 = a mean(g), c2 = a invstd mean(g xhat); mean(g xhat) and mean(g) are
// m_gx[c] * scale and m_g[c] * scale.
struct DxCoef {
  Affine f;
  float c1, c2;
  __device__ float operator()(float x, float dy, int relu) const {
    const float xm = x - f.mean;
    const float g = (relu && !(f(xm) > 0.0f)) ? 0.0f : dy;
    return fmaf(f.a, g, -fmaf(c2, xm, c1));
  }
};

__device__ __forceinline__ DxCoef dx_coef(const float* stats, const float* w, const float* b,
                                          const float* m_gx, const float* m_g, float scale, int C,
                                          int c) {
  const Affine f = affine(stats, w, b, C, c);
  return DxCoef{f, f.a * (m_g[c] * scale), f.a * f.invstd * (m_gx[c] * scale)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_dx_cl(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx, long long rows,
      int C, int L, const float* __restrict__ stats, const float* __restrict__ w,
      const float* __restrict__ b, const float* __restrict__ m_gx,
      const float* __restrict__ m_g, float scale, int relu) {
  const int P = kThreads / L, tx = threadIdx.x % L, ty = threadIdx.x / L;
  if (ty >= P) return;
  const int c0 = (blockIdx.y * L + tx) * kVec;
  // a DxCoef per channel, held as plain arrays
  float mean[kVec], a[kVec], beta[kVec], c1[kVec], c2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const DxCoef k = dx_coef(stats, w, b, m_gx, m_g, scale, C, c0 + j);
    mean[j] = k.f.mean, a[j] = k.f.a, beta[j] = k.f.beta, c1[j] = k.c1, c2[j] = k.c2;
  }
  const long long step = (long long)gridDim.x * P;
  long long r = (long long)blockIdx.x * P + ty;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float q[kUnroll][kVec], e[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<kVec>(x + (r + u * step) * C + c0, q[u]);
      load<kVec>(dy + (r + u * step) * C + c0, e[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xm = q[u][j] - mean[j];
        const float g = (relu && !(fmaf(xm, a[j], beta[j]) > 0.0f)) ? 0.0f : e[u][j];
        q[u][j] = fmaf(a[j], g, -fmaf(c2[j], xm, c1[j]));
      }
      store<kVec>(dx + (r + u * step) * C + c0, q[u]);
    }
  }
  for (; r < rows; r += step) {
    float q[kVec], e[kVec];
    load<kVec>(x + r * C + c0, q);
    load<kVec>(dy + r * C + c0, e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xm = q[j] - mean[j];
      const float g = (relu && !(fmaf(xm, a[j], beta[j]) > 0.0f)) ? 0.0f : e[j];
      q[j] = fmaf(a[j], g, -fmaf(c2[j], xm, c1[j]));
    }
    store<kVec>(dx + r * C + c0, q);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
bn_reduce_cf(const T* __restrict__ dy, const T* __restrict__ x, int n, int C, long long S,
          const float* __restrict__ w, const float* __restrict__ b, int relu, float* part,
          unsigned* counters, Grads out) {
  __shared__ float sh[2 * kThreads];
  const int c = blockIdx.y;
  const Affine f = affine(out.stats, w, b, C, c);
  float v[2] = {0.0f, 0.0f};
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t base = ((size_t)i * C + c) * S;
    for (long long s = (long long)threadIdx.x * N; s < S; s += kThreads * N) {
      float q[N], e[N];
      load<N>(x + base + s, q);
      load<N>(dy + base + s, e);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xm = q[j] - f.mean;
        const float g = (relu && !(f(xm) > 0.0f)) ? 0.0f : e[j];
        v[0] += g;
        v[1] = fmaf(g, xm, v[1]);
      }
    }
  }
  sum_over_rows<2>(v, sh, 1, kThreads);
  if (threadIdx.x == 0) write_partials<1>(part, C, c, v);
  if (!last_of_group(counters)) return;
  float tot[2];
  if (merge_partials(part, C, c, 1, tot, sh) >= 0) out.finish(c, tot[0], tot[1]);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
bn_dx_cf(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx, int n, int C,
      long long S, const float* __restrict__ stats, const float* __restrict__ w,
      const float* __restrict__ b, const float* __restrict__ m_gx,
      const float* __restrict__ m_g, float scale, int relu) {
  const int c = blockIdx.y;
  const DxCoef k = dx_coef(stats, w, b, m_gx, m_g, scale, C, c);
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t base = ((size_t)i * C + c) * S;
    for (long long s = (long long)threadIdx.x * N; s < S; s += kThreads * N) {
      float q[N], e[N];
      load<N>(x + base + s, q);
      load<N>(dy + base + s, e);
#pragma unroll
      for (int j = 0; j < N; ++j) q[j] = k(q[j], e[j], relu);
      store<N>(dx + base + s, q);
    }
  }
}

// ---- launches --------------------------------------------------------------

struct Shape {
  int n, C, S, channels_last, grid_x, lanes;
  long long rows() const { return (long long)n * S; }
  float inv_count() const { return (float)(1.0 / ((double)n * S)); }
  dim3 grid() const { return dim3(grid_x, channels_last ? C / kVec / lanes : C); }
};

template <typename T, int N>
void fwd_cf(const T* x, T* y, const float* w, const float* b, float* part, unsigned* counters,
            const Shape& sh, Stats fin, int stage, cudaStream_t st) {
  const int relu = (fin.flags & kRelu) != 0;
  if (stage != kApplyOnly)
    bn_stats_cf<T, N><<<sh.grid(), kThreads, 0, st>>>(x, sh.n, sh.C, sh.S, sh.inv_count(), part,
                                                  counters, fin);
  else
    bn_finish_global<<<(sh.C + kThreads - 1) / kThreads, kThreads, 0, st>>>(fin);
  if (stage != kStatsOnly)
    bn_apply_cf<T, N><<<sh.grid(), kThreads, 0, st>>>(x, y, sh.n, sh.C, sh.S, fin.out, w, b, relu);
}

template <typename T>
void fwd(const T* x, T* y, const float* w, const float* b, float* part, unsigned* counters,
         const Shape& sh, Stats fin, int stage, cudaStream_t st) {
  if (!sh.channels_last) {
    if (sh.S % kVec == 0)
      fwd_cf<T, kVec>(x, y, w, b, part, counters, sh, fin, stage, st);
    else
      fwd_cf<T, 1>(x, y, w, b, part, counters, sh, fin, stage, st);
    return;
  }
  const int relu = (fin.flags & kRelu) != 0;
  if (stage != kApplyOnly)
    bn_stats_cl<T><<<sh.grid(), kThreads, 0, st>>>(x, sh.rows(), sh.C, sh.lanes, sh.inv_count(),
                                                part, counters, fin);
  else
    bn_finish_global<<<(sh.C + kThreads - 1) / kThreads, kThreads, 0, st>>>(fin);
  if (stage != kStatsOnly)
    bn_apply_cl<T><<<sh.grid(), kThreads, 0, st>>>(x, y, sh.rows(), sh.C, sh.lanes, fin.out, w, b,
                                               relu);
}

template <typename T, int N>
void bwd_cf(const T* dy, const T* x, T* dx, const float* w, const float* b, const float* m_gx,
            const float* m_g, float scale, float* part, unsigned* counters, const Shape& sh,
            Grads out, int relu, int stage, cudaStream_t st) {
  if (stage != kApplyOnly)
    bn_reduce_cf<T, N><<<sh.grid(), kThreads, 0, st>>>(dy, x, sh.n, sh.C, sh.S, w, b, relu, part,
                                                   counters, out);
  if (stage != kStatsOnly)
    bn_dx_cf<T, N><<<sh.grid(), kThreads, 0, st>>>(dy, x, dx, sh.n, sh.C, sh.S, out.stats, w, b,
                                               m_gx, m_g, scale, relu);
}

template <typename T>
void bwd(const T* dy, const T* x, T* dx, const float* w, const float* b, const float* m_gx,
         const float* m_g, float scale, float* part, unsigned* counters, const Shape& sh,
         Grads out, int relu, int stage, cudaStream_t st) {
  if (!sh.channels_last) {
    if (sh.S % kVec == 0)
      bwd_cf<T, kVec>(dy, x, dx, w, b, m_gx, m_g, scale, part, counters, sh, out, relu, stage, st);
    else
      bwd_cf<T, 1>(dy, x, dx, w, b, m_gx, m_g, scale, part, counters, sh, out, relu, stage, st);
    return;
  }
  if (stage != kApplyOnly)
    bn_reduce_cl<T><<<sh.grid(), kThreads, 0, st>>>(dy, x, sh.rows(), sh.C, sh.lanes, w, b, relu,
                                                 part, counters, out);
  if (stage != kStatsOnly)
    bn_dx_cl<T><<<sh.grid(), kThreads, 0, st>>>(dy, x, dx, sh.rows(), sh.C, sh.lanes, out.stats, w,
                                             b, m_gx, m_g, scale, relu);
}

}  // namespace

// x, y (N, C, H, W) in bf16 (is_bf16) or f32, both channels-last or both
// NCHW-contiguous, 16-byte aligned, C a multiple of 8; weight, bias,
// running_mean, running_var (C) and stats (2, C) f32; partials (2, grid_x, C)
// f32; counters one zeroed 32-bit word per channel group, left zeroed.
// `lanes`: 16-byte vectors of a channels-last row that a block's group holds
// (ops/batchnorm.py:plan). Stages: 0 statistics, stats = (mean, invstd), the
// running statistics updated (flags & 1), then y = relu(...) (relu: flags &
// 2; flags & 4: the variance as E[x^2] - E[x]^2); 1 the statistics alone as
// the local (mean, E[x^2]); 2 stats holding the global (mean, E[x^2]):
// finish them, then y. Launches on `stream` and returns cudaGetLastError().
extern "C" int batch_norm_relu_fwd(const void* x, void* y, const void* weight, const void* bias,
                                   void* running_mean, void* running_var, void* stats,
                                   void* partials, void* counters, int n, int C, int S,
                                   int channels_last, int is_bf16, int grid_x, int lanes,
                                   float momentum, float rest, float eps, int flags, int stage,
                                   void* stream) {
  const Shape sh{n, C, S, channels_last, grid_x, lanes};
  const Stats fin{(float*)stats, (float*)running_mean, (float*)running_var, C, flags,
                  stage == kStatsOnly, momentum, rest, eps};
  const float *w = (const float*)weight, *b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    fwd<__nv_bfloat16>((const __nv_bfloat16*)x, (__nv_bfloat16*)y, w, b, (float*)partials,
                       (unsigned*)counters, sh, fin, stage, st);
  else
    fwd<float>((const float*)x, (float*)y, w, b, (float*)partials, (unsigned*)counters, sh, fin,
               stage, st);
  return (int)cudaGetLastError();
}

// dy, x, dx as x and y above; stats (2, C) the forward's (mean, invstd);
// dweight, dbias (C) f32. Stages: 0 the sums, dweight = sum g xhat and
// dbias = sum g, then dx from their means; 1 the sums alone; 2 dx from
// moments (2, C) f32, the global means of g xhat and of g (the sums of all
// ranks over all ranks' count). flags & 2: the ReLU's mask. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int batch_norm_relu_bwd(const void* dy, const void* x, void* dx, const void* weight,
                                   const void* bias, const void* stats, void* dweight,
                                   void* dbias, const void* moments, void* partials,
                                   void* counters, int n, int C, int S, int channels_last,
                                   int is_bf16, int grid_x, int lanes, int flags, int stage,
                                   void* stream) {
  const Shape sh{n, C, S, channels_last, grid_x, lanes};
  const Grads out{(float*)dweight, (float*)dbias, (const float*)stats, C};
  const float *w = (const float*)weight, *b = (const float*)bias;
  const bool given = stage == kApplyOnly;
  const float* m_gx = given ? (const float*)moments : out.dweight;
  const float* m_g = given ? (const float*)moments + C : out.dbias;
  const float scale = given ? 1.0f : sh.inv_count();
  const int relu = (flags & kRelu) != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    bwd<__nv_bfloat16>((const __nv_bfloat16*)dy, (const __nv_bfloat16*)x, (__nv_bfloat16*)dx, w,
                       b, m_gx, m_g, scale, (float*)partials, (unsigned*)counters, sh, out, relu,
                       stage, st);
  else
    bwd<float>((const float*)dy, (const float*)x, (float*)dx, w, b, m_gx, m_g, scale,
               (float*)partials, (unsigned*)counters, sh, out, relu, stage, st);
  return (int)cudaGetLastError();
}
