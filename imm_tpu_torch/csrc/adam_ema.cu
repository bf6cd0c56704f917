// Adam with optax's conventions, the parameter EMA and the gradients' global
// norm over all of a model's parameter leaves, in place, for Hopper (sm_90a)
// (K6).
//
// Replaces no Pallas kernel: on the TPU, XLA fused optax's update. PyTorch
// ran it leaf by leaf, ~19 generic launches a leaf (1,465 a step for the
// model's 76 leaves), each a pass over one small tensor, and the host's time
// to issue them set the step's pace.
//
// Two launches a step, over every leaf at once:
//   adam_norm    sum g^2 over all leaves; then, in the last block to finish,
//                the step's scalars from the device-resident count: the rate
//                (optax's piecewise-constant schedule), 1 - b1^t and
//                1 - b2^t (t = count + 1), the NaN guard's ok (the loss and
//                the norm finite) and the metrics; count += 1 where ok.
//                Only that one thread reads and writes count, after the
//                scalars are derived; adam_update reads the scalars, never
//                count, so the count has no race.
//   adam_update  each element of each leaf, in f32: g clipped to the global
//                norm (optax's clip_by_global_norm), mu and nu, the update
//                u = (mu / bias1) / (sqrt(nu / bias2) + eps) (eps outside the
//                root), + wd * p (adamw's decoupled decay), p += -lr * u, and
//                the EMA e = e * d + p * (1 - d). A step that the guard finds
//                not ok writes nothing.
// Each operation rounds as the per-leaf PyTorch ops round (__fmul_rn and
// __fadd_rn keep nvcc from contracting them into fused multiply-adds; the
// division and sqrtf are IEEE's, as without fast-math), so on the card the
// update differs from the per-leaf path only by the norm's order of
// summation (where clipping is on) and powf's last bit in the two bias
// corrections.
//
// What bounds it: device-memory bytes. The update reads p, g, mu, nu and the
// EMA and writes all but g, 36 bytes a parameter (28 without the EMA); the
// norm reads g once more, 4. Design:
//   - The leaves' pointers and sizes travel by value, in the kernels'
//     argument struct (Args, under the 4 KB of kernel arguments; read in
//     place, __grid_constant__, not copied to each thread's stack): nothing
//     is copied to the device and nothing waits on the host. A model with
//     more than kMaxLeaves leaves would take two launches of each kernel
//     over halves of the leaves, the norm's second adding to the first's
//     sum; ops/adam.py refuses it until then.
//   - The work is groups of 4 consecutive elements, one 16-byte access of
//     each tensor where its address allows. The groups of all leaves are
//     laid end to end and the grid's threads take them in turn, so every
//     thread has the same share (~8 groups at 528 blocks) whatever the
//     leaves' sizes (3 to 612,864 elements here). Walked leaf by leaf, the
//     first threads would take a group of every leaf, ~80 to the others' 8:
//     0.177 ms a step against 0.072 on an H100 at the model's 76 leaves.
//   - The norm repeats bit for bit: each thread adds its elements in a fixed
//     order, each block its threads in a fixed tree, and the grid's last
//     block (a counter that atomicInc wraps back to 0 for the next launch)
//     adds the blocks' partials in a fixed order: no float atomics.
//   - A convolution's gradient may arrive channels-last while its weight and
//     moments are contiguous: the update then reads g at the element's
//     channels-last offset; the norm reads g in its own order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 80;
constexpr int kMaxBounds = 4;

// the step's scalars (float slots), as ops/adam.py reads them
enum { kGradNorm, kLoss, kNonfinite, kLr, kBias1, kBias2, kNorm, kScalars };
// flags
constexpr int kGuard = 1, kClip = 2, kDecay = 4, kEma = 8;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* e[kMaxLeaves];  // null without the EMA
  int n[kMaxLeaves];     // elements
  // 0: g laid out as p (contiguous); else g is channels-last of a 4-D p
  // (O, C, H, W): C * 256 + H * W
  int cl[kMaxLeaves];
};

struct Step {
  int* count;           // optimizer updates done (int32), advanced where ok
  const float* loss;    // the step's total loss, for the guard
  float* scal;          // kScalars floats, written by adam_norm
  float* part;          // a partial sum a block of adam_norm
  unsigned* counter;    // zeroed, left zeroed
  int leaves, flags, bounds;
  int bound[kMaxBounds];    // counts from which the rate is scaled, ascending
  float ratio[kMaxBounds];  // by these
  float lr, b1, b2, rb1, rb2, eps, wd, clip, d, rd;  // rb1 = 1 - b1, rd = 1 - d, ...
};

struct Args {
  Leaves l;
  Step s;
};
static_assert(sizeof(Args) == 3968, "Args must match ops/adam.py's _Args");
static_assert(sizeof(Args) <= 4096, "kernel arguments are limited to 4 KB");

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// elements 4q .. 4q + 3 of p, 0 past n
__device__ __forceinline__ void load4(const float* p, long long q, int n, bool vec, float (&x)[4]) {
  const long long i = 4 * q;
  if (vec && i + 4 <= n) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = i + k < n ? p[i + k] : 0.0f;
}

__device__ __forceinline__ void store4(float* p, long long q, int n, bool vec,
                                       const float (&x)[4]) {
  const long long i = 4 * q;
  if (vec && i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < n) p[i + k] = x[k];
}

// where element i of a contiguous (O, C, H, W) tensor lies in its
// channels-last copy; cl = C * 256 + H * W
__device__ __forceinline__ unsigned channels_last_offset(unsigned i, unsigned cl) {
  const unsigned c = cl >> 8, hw = cl & 255u, chw = c * hw;
  const unsigned o = i / chw, r = i - o * chw, ci = r / hw;
  return o * chw + (r - ci * hw) * c + ci;
}

// the sum of v over the block's threads, in the same tree every time
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if ((int)threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();
  return total;
}

// one thread of the last block: the step's scalars from the count and the
// squared norm; the count advanced where the step goes ahead
__device__ void finish(const Step& s, float sq) {
  const int count = *s.count;
  float lr = s.lr;
  for (int b = 0; b < s.bounds; ++b)
    if (count >= s.bound[b]) lr = __fmul_rn(lr, s.ratio[b]);
  const float t = (float)(count + 1);
  const float loss = *s.loss;
  const bool ok = !(s.flags & kGuard) || (isfinite(loss) && isfinite(sq));
  const float norm = sqrtf(sq);
  float* o = s.scal;
  o[kGradNorm] = ok ? norm : 0.0f;
  o[kLoss] = ok ? loss : 0.0f;
  o[kNonfinite] = ok ? 0.0f : 1.0f;
  o[kLr] = lr;
  o[kBias1] = 1.0f - powf(s.b1, t);
  o[kBias2] = 1.0f - powf(s.b2, t);
  o[kNorm] = norm;
  if (ok) *s.count = count + 1;
}

// fn(leaf, q) for each group q of 4 elements of each leaf that falls to this
// thread: the leaves' groups laid end to end, the grid's threads taking them
// in turn, so that every thread has the same share whatever the leaves' sizes
template <class F>
__device__ __forceinline__ void for_each_group(const Leaves& L, int leaves, F&& fn) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long G = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long lo = 0, hi = (L.n[0] + 3) / 4;
  int l = 0;
  for (;; G += stride) {
    while (G >= hi) {
      if (++l == leaves) return;
      lo = hi;
      hi += (L.n[l] + 3) / 4;
    }
    fn(l, G - lo);
  }
}

__global__ void __launch_bounds__(kThreads) adam_norm(const __grid_constant__ Args a) {
  __shared__ float sh[kThreads];
  __shared__ bool last;
  float acc = 0.0f;
  for_each_group(a.l, a.s.leaves, [&](int l, long long q) {
    float x[4];
    load4(a.l.g[l], q, a.l.n[l], aligned16(a.l.g[l]), x);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(x[k], x[k], acc);
  });
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) a.s.part[blockIdx.x] = acc;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(a.s.counter, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  float sq = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) sq += __ldcg(a.s.part + b);
  sq = block_sum(sq, sh);
  if (threadIdx.x == 0) finish(a.s, sq);
}

__global__ void __launch_bounds__(kThreads) adam_update(const __grid_constant__ Args a) {
  const Step& s = a.s;
  const float* o = s.scal;
  if (o[kNonfinite] != 0.0f) return;  // the guard's skipped step
  const float step = -o[kLr], bias1 = o[kBias1], bias2 = o[kBias2], norm = o[kNorm];
  const bool clip = (s.flags & kClip) && !(norm < s.clip);
  const bool decay = (s.flags & kDecay) != 0, ema = (s.flags & kEma) != 0;
  for_each_group(a.l, s.leaves, [&](int l, long long q) {
    float *p = a.l.p[l], *m = a.l.m[l], *v = a.l.v[l], *e = a.l.e[l];
    const float* g = a.l.g[l];
    const int n = a.l.n[l], cl = a.l.cl[l];
    const bool vec = aligned16(p) && aligned16(m) && aligned16(v) && (!ema || aligned16(e));
    float P[4], G[4], M[4], V[4], E[4];
    load4(p, q, n, vec, P);
    load4(m, q, n, vec, M);
    load4(v, q, n, vec, V);
    if (ema) load4(e, q, n, vec, E);
    if (cl) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = 4 * q + k;
        G[k] = i < n ? g[channels_last_offset((unsigned)i, (unsigned)cl)] : 0.0f;
      }
    } else {
      load4(g, q, n, aligned16(g), G);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float gk = G[k];
      if (clip) gk = __fmul_rn(gk / norm, s.clip);
      M[k] = __fadd_rn(__fmul_rn(s.rb1, gk), __fmul_rn(s.b1, M[k]));
      V[k] = __fadd_rn(__fmul_rn(s.rb2, __fmul_rn(gk, gk)), __fmul_rn(s.b2, V[k]));
      float u = (M[k] / bias1) / __fadd_rn(sqrtf(V[k] / bias2), s.eps);
      if (decay) u = __fadd_rn(u, __fmul_rn(s.wd, P[k]));
      P[k] = __fadd_rn(P[k], __fmul_rn(step, u));
      if (ema) E[k] = __fadd_rn(__fmul_rn(E[k], s.d), __fmul_rn(P[k], s.rd));
    }
    store4(p, q, n, vec, P);
    store4(m, q, n, vec, M);
    store4(v, q, n, vec, V);
    if (ema) store4(e, q, n, vec, E);
  });
}

}  // namespace

// One optimizer step: `args` points to the host's Args (ops/adam.py:_Args),
// copied into both launches' arguments; `grid` blocks of kThreads each, and
// Args.s.part holds `grid` floats. Launches adam_norm, then adam_update, on
// `stream` and returns cudaGetLastError().
extern "C" int adam_ema(const void* args, int grid, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  cudaStream_t st = (cudaStream_t)stream;
  adam_norm<<<grid, kThreads, 0, st>>>(a);
  adam_update<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
