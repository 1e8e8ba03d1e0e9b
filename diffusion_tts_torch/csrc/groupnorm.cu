// GroupNorm (+ per-sample pre-add, + SiLU) for Hopper (sm_90a), plain C
// interface, contiguous NCHW input.
//
// Replaces the TPU kernel _gn_kernel behind
// diffusion_tts_tpu/ops/pallas/groupnorm.py::group_norm_silu and
// ::group_norm_silu_prebias. Same function: per (batch, group) fp32 raw
// moments sum(v) and sum(v^2) of v = x (+ pre[b, c]), mean = sum / n and
// var = max(sumsq / n - mean^2, 0) (the clamp of _gn_kernel), then
// ((v - mean) * rsqrt(var + eps)) * scale + bias in fp32, optional SiLU, and
// one rounding to the input dtype. scale/bias are [C] or per-sample [B, C]
// (affine_bstride 0 or C); pre is [B, C] or null. The TPU kernel folds the
// pre-add into the raw moments analytically; here it is added to each value
// as the moments are taken, the same moments without a pass of its own.
//
// What bounds it on this card: memory. Each element is read twice (once for
// the moments, once to normalize) and written once; the least any GroupNorm
// moves is one read and one write, 2 * bytes(x) / 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks one batch element's
// rows in a sequential grid with the moments in VMEM scratch. Blocks on the
// card run in no order, so the moments are split: launch 1 gives one block
// to each (batch, channel, chunk of at most `chunk` pixels) and writes its
// fp32 partial (sum, sumsq); launch 2 gives the same blocks the normalize
// pass, each first reducing its group's partials (cg * chunks of them, in a
// fixed order: the result does not depend on scheduling). At batch 1 the
// VAE's conv_norm_out [1, 128, 512, 512] is 4,096 blocks per launch, so all
// 132 SMs are busy; one block per (batch, group) would have left 100 idle.
// Scalar loads, one element per thread per step, coalesced along the pixel
// axis; vector loads and a single-read (cluster) form are later work.
//
// Second entry, dtts_group_norm_stats: replaces the TPU kernel
// _gn_stats_kernel behind groupnorm.py::group_norm_stats. Same function: the
// moments of each (batch, group) from ONE read of x, written as the
// per-(batch, channel) fp32 mean and rstd of the channel's group, for a
// consumer that normalizes as it loads (the 3x3 conv's prologue,
// csrc/conv3x3.cu). Bound: memory, bytes(x) / 3.35 TB/s. The TPU kernel
// carries its column sums in scratch from one grid step to the next; blocks
// here run in no order, so launch 1 is the moments pass above, unchanged,
// and launch 2 gives one warp to each (batch, group): it reduces the
// group's partials in the same fixed order as the normalize pass does and
// writes the two values to each of the group's channels.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (chunks, C, B): partial[(b * C + c) * chunks + s] = (sum, sumsq) of
// v = x[b, c, s * chunk : (s + 1) * chunk] (+ pre[b, c]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_moments_kernel(const T* __restrict__ x, const float* __restrict__ pre,
                  float2* __restrict__ partial, int c, int hw, int chunk) {
  const int s = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int64_t row = (int64_t)b * c + ch;
  const T* xp = x + row * hw;
  const int end = min(hw, (s + 1) * chunk);
  const float p = pre ? pre[row] : 0.f;
  float sum = 0.f, sq = 0.f;
  for (int i = s * chunk + threadIdx.x; i < end; i += kThreads) {
    float v = to_f32(xp[i]) + p;
    sum += v;
    sq = fmaf(v, v, sq);
  }
  __shared__ float red[2][kThreads / 32];
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += red[0][w];
      tq += red[1][w];
    }
    partial[row * gridDim.x + s] = make_float2(ts, tq);
  }
}

// One full warp reduces a group's n partials in a fixed order; every lane
// returns (mean, rstd) with the variance from raw moments clamped at 0.
__device__ __forceinline__ float2 group_mean_rstd(const float2* __restrict__ part, int n,
                                                  float cnt, float eps) {
  float sum = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += 32) {
    float2 v = part[i];
    sum += v.x;
    sq += v.y;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / cnt;
  const float var = fmaxf(sq / cnt - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// grid (chunks, C, B): normalize the same chunk with its group's statistics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ pre,
                const float2* __restrict__ partial, T* __restrict__ out, int c, int hw,
                int cg, int chunk, int affine_bstride, float eps, int silu) {
  const int s = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int64_t row = (int64_t)b * c + ch;
  __shared__ float stats[2];
  if (threadIdx.x < 32) {
    const int g0 = ch - ch % cg;  // first channel of this group
    const float2 st = group_mean_rstd(partial + ((int64_t)b * c + g0) * gridDim.x,
                                      cg * gridDim.x, (float)cg * (float)hw, eps);
    if (threadIdx.x == 0) {
      stats[0] = st.x;
      stats[1] = st.y;
    }
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];
  const float sc = scale[(int64_t)b * affine_bstride + ch];
  const float bi = bias[(int64_t)b * affine_bstride + ch];
  const float p = pre ? pre[row] : 0.f;
  const T* xp = x + row * hw;
  T* op = out + row * hw;
  const int end = min(hw, (s + 1) * chunk);
  for (int i = s * chunk + threadIdx.x; i < end; i += kThreads) {
    float v = (to_f32(xp[i]) + p - mean) * rstd;
    v = v * sc + bi;
    if (silu) v = v / (1.f + expf(-v));
    op[i] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, const float* pre,
                   void* partial, void* out, int b, int c, int hw, int groups, int chunk,
                   int affine_bstride, float eps, int silu, cudaStream_t stream) {
  dim3 grid((hw + chunk - 1) / chunk, c, b);
  gn_moments_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), pre, static_cast<float2*>(partial), c, hw, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, pre, static_cast<const float2*>(partial),
      static_cast<T*>(out), c, hw, c / groups, chunk, affine_bstride, eps, silu);
  return cudaGetLastError();
}

// grid (groups, B), one warp: mean[b, ch] and rstd[b, ch] of ch's group for
// every channel of the group, from the partials of gn_moments_kernel.
__global__ void __launch_bounds__(32)
gn_stats_finalize_kernel(const float2* __restrict__ partial, float* __restrict__ mean,
                         float* __restrict__ rstd, int c, int hw, int cg, int chunks,
                         float eps) {
  const int64_t first = (int64_t)blockIdx.y * c + (int64_t)blockIdx.x * cg;
  const float2 st = group_mean_rstd(partial + first * chunks, cg * chunks,
                                    (float)cg * (float)hw, eps);
  for (int i = threadIdx.x; i < cg; i += 32) {
    mean[first + i] = st.x;
    rstd[first + i] = st.y;
  }
}

template <typename T>
cudaError_t launch_stats(const void* x, void* partial, float* mean, float* rstd, int b, int c,
                         int hw, int groups, int chunk, float eps, cudaStream_t stream) {
  const int chunks = (hw + chunk - 1) / chunk;
  gn_moments_kernel<T><<<dim3(chunks, c, b), kThreads, 0, stream>>>(
      static_cast<const T*>(x), nullptr, static_cast<float2*>(partial), c, hw, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_stats_finalize_kernel<<<dim3(groups, b), 32, 0, stream>>>(
      static_cast<const float2*>(partial), mean, rstd, c, hw, c / groups, chunks, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and out: contiguous [B, C, HW];
// scale/bias: fp32 [C] (affine_bstride 0) or [B, C] (affine_bstride C);
// pre: fp32 [B, C] or null; partial: fp32 scratch of 2 * B * C *
// ceil(HW / chunk) values. Two launches. Returns the first failing launch's
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int dtts_group_norm(const void* x, const float* scale, const float* bias,
                               const float* pre, void* partial, void* out, int dtype, int b,
                               int c, int hw, int groups, int chunk, int affine_bstride,
                               float eps, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || c % groups || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, scale, bias, pre, partial, out, b, c, hw, groups, chunk,
                         affine_bstride, eps, silu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, pre, partial, out, b, c, hw, groups, chunk,
                                 affine_bstride, eps, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16. x: contiguous [B, C, HW]; partial: fp32
// scratch of 2 * B * C * ceil(HW / chunk) values; mean, rstd: fp32 [B, C].
// Two launches (moments, then the per-group finalize); x is read once.
extern "C" int dtts_group_norm_stats(const void* x, void* partial, float* mean, float* rstd,
                                     int dtype, int b, int c, int hw, int groups, int chunk,
                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups <= 0 || c % groups || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_stats<float>(x, partial, mean, rstd, b, c, hw, groups, chunk, eps, s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, partial, mean, rstd, b, c, hw, groups, chunk, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
