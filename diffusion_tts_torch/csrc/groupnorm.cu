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
// What bounds it on this card: memory. The least any GroupNorm moves is one
// read and one write of x, 2 * bytes(x) / 3.35 TB/s.
//
// Two designs, picked in Python (ops/kernels/groupnorm.py::gn_route):
//
// slab (route 1): fp32 and bf16 with each channel's row a multiple of 16
// bytes (HW a multiple of 8 in bf16, of 4 in fp32): every GroupNorm+SiLU of
// the SD search. One launch that reads x once. In NCHW a (batch, group) is
// one contiguous slab of cg * HW values, and the TPU kernel's sequential
// two-phase grid (statistics into VMEM scratch, then normalize) becomes one
// thread-block cluster of cs = 1, 2, 4 or 8 CTAs per (batch, group), cs
// chosen in Python (gn_slab_cluster). Each CTA owns a contiguous part of the
// slab, cut at 16-byte boundaries, and copies it into dynamic shared memory
// with 16-byte cp.async copies in kSlabStages commit groups, summing the fp32
// moments of each stage while the next lands (a thread sums what it copied
// itself: no barrier between the stages). After a cluster barrier every CTA
// reads the cs partial moments over distributed shared memory and adds them
// in rank order, so every CTA holds the same mean and rstd and two runs are
// bit-identical: no atomics and no scratch in device memory. Each CTA then
// normalizes its part from shared memory and writes 16-byte vectors; a
// vector never straddles two channels. A part holds at most kSlabBudget
// bytes, so that two CTAs fit on an SM (three, by registers, where the part
// is smaller); cs grows until it does, and then while the card has fewer
// than 132 CTAs to run. A group that eight such parts cannot hold (the
// VAE's conv_norm_out, 2 MB a group) keeps kSlabBudget bytes of each part
// resident and reads the rest of the part a second time, in the normalize
// pass, from device memory: for 2 MB over 8 CTAs, 160 of each 256 KB. That
// second read comes mostly from L2; in trials on the card it was faster
// than holding 224 KB resident at one CTA per SM, where fewer clusters fit
// at once and no SM overlaps one CTA's loads with another's stores.
// Route constants: kSlabRowBytes = 16, kSlabBudget = 98304;
//
// v1 (route 0, the first design): any HW. Each element is read twice (once
// for the moments, once to normalize) and written once. Blocks on the card
// run in no order, so the moments are split: launch 1 gives one block to
// each (batch, channel, chunk of at most `chunk` pixels) and writes its fp32
// partial (sum, sumsq); launch 2 gives the same blocks the normalize pass,
// each first reducing its group's partials (cg * chunks of them, in a fixed
// order: the result does not depend on scheduling). Scalar loads, one
// element per thread per step, coalesced along the pixel axis.
//
// Second entry, dtts_group_norm_stats: replaces the TPU kernel
// _gn_stats_kernel behind groupnorm.py::group_norm_stats. Same function: the
// moments of each (batch, group) from ONE read of x, written as the
// per-(batch, channel) fp32 mean and rstd of the channel's group, for a
// consumer that normalizes as it loads (the 3x3 conv's prologue,
// csrc/conv3x3.cu). Bound: memory, bytes(x) / 3.35 TB/s. The TPU kernel
// carries its column sums in scratch from one grid step to the next; blocks
// here run in no order, so launch 1 is v1's moments pass above, unchanged,
// and launch 2 gives one warp to each (batch, group): it reduces the
// group's partials in the same fixed order as the normalize pass does and
// writes the two values to each of the group's channels.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace coop = cooperative_groups;

constexpr int kThreads = 256;
// The slab route (the header states the same numbers; so does
// ops/kernels/groupnorm.py): rows of whole 16-byte vectors, at most
// kSlabBudget bytes of a part resident per CTA (two CTAs per SM).
constexpr int kSlabRowBytes = 16, kSlabBudget = 98304;
constexpr int kSlabThreads = 512;
constexpr int kSlabStages = 4;
constexpr int kSlabUnroll = 4;  // vectors a thread reads before it uses them

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

// ------------------------------------------------------------------ slab

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// The two halves of a cluster barrier: arrive after the last read of another
// CTA's shared memory, wait before exiting, so that no CTA leaves while
// another may still read it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 bytes of T as 16 / sizeof(T) floats, and back (one rounding each).
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack16(const float* f);
template <> __device__ __forceinline__ uint4 pack16<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The channel of a thread's vectors first, first + step, ... in a slab of
// vpc vectors per channel row: three divisions at the start, none per step.
struct ChannelWalk {
  int ch, rem, q, r, vpc;
  __device__ __forceinline__ ChannelWalk(int first, int step, int vpc_)
      : ch(first / vpc_), rem(first % vpc_), q(step / vpc_), r(step % vpc_), vpc(vpc_) {}
  __device__ __forceinline__ void next() {
    ch += q;
    rem += r;
    if (rem >= vpc) {
      rem -= vpc;
      ++ch;
    }
  }
};

// grid (cs, groups, B), clusters of (cs, 1, 1): the cluster of (b, g) owns
// the slab x[b, g * cg : (g + 1) * cg, :], nvec 16-byte vectors; CTA `rank`
// owns vectors [rank * per, (rank + 1) * per) of it and keeps the first
// `resident_cap` of them in shared memory. Thread tid takes the part's
// vectors tid, tid + kSlabThreads, ... in every pass (coalesced).
template <typename T>
__global__ void __launch_bounds__(kSlabThreads, 3)  // at most 40 registers: 3 CTAs per SM
gn_slab_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ pre,
               T* __restrict__ out, int c, int hw, int cg, int affine_bstride,
               int resident_cap, float eps, int silu) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) uint4 part[];
  __shared__ float red[2][kSlabThreads / 32];
  __shared__ float2 cta_moments, group_stats;
  coop::cluster_group cluster = coop::this_cluster();

  const int cs = gridDim.x, rank = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * c + (int64_t)g * cg;  // the group's first (b, c) row
  const uint4* xs = reinterpret_cast<const uint4*>(x + row0 * hw);
  uint4* os = reinterpret_cast<uint4*>(out + row0 * hw);
  const int vpc = hw / kVec;  // vectors per channel row
  const int nvec = cg * vpc;
  const int per = (nvec + cs - 1) / cs;
  const int v0 = min(nvec, rank * per);
  const int count = min(nvec, v0 + per) - v0;
  const int resident = min(count, resident_cap);
  const float* pre_g = pre ? pre + row0 : nullptr;

  // 1. every copy of the resident part at once, in kSlabStages commit groups
  const int steps = (resident + kSlabThreads - 1) / kSlabThreads;
#pragma unroll
  for (int s = 0; s < kSlabStages; ++s) {
    for (int k = steps * s / kSlabStages; k < steps * (s + 1) / kSlabStages; ++k) {
      const int j = tid + k * kSlabThreads;
      if (j < resident) cp_async16(part + j, xs + v0 + j);
    }
    cp_async_commit();
  }

  float sum = 0.f, sq = 0.f;
  auto add = [&](const uint4& u, int ch) {
    float f[kVec];
    unpack16<T>(u, f);
    const float p = pre_g ? __ldg(pre_g + ch) : 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float v = f[i] + p;
      sum += v;
      sq = fmaf(v, v, sq);
    }
  };
  // fn(u, j, channel) for each vector j of the part past the resident cap,
  // in order, read from device memory kSlabUnroll at a time
  auto each_beyond = [&](auto&& fn) {
    ChannelWalk walk(v0 + resident + tid, kSlabThreads, vpc);
    int j = resident + tid;
    for (; j + (kSlabUnroll - 1) * kSlabThreads < count; j += kSlabUnroll * kSlabThreads) {
      uint4 u[kSlabUnroll];
#pragma unroll
      for (int i = 0; i < kSlabUnroll; ++i) u[i] = __ldg(xs + v0 + j + i * kSlabThreads);
#pragma unroll
      for (int i = 0; i < kSlabUnroll; ++i, walk.next()) fn(u[i], j + i * kSlabThreads, walk.ch);
    }
    for (; j < count; j += kSlabThreads, walk.next()) fn(__ldg(xs + v0 + j), j, walk.ch);
  };
  // 2. the part beyond the resident cap, while the copies are in flight
  each_beyond([&](const uint4& u, int, int ch) { add(u, ch); });
  // fn(u, j, channel) for the resident vectors j = tid + k * kSlabThreads,
  // k in [k0, k1), in order, read from shared memory kSlabUnroll at a time
  auto each_resident = [&](int k0, int k1, ChannelWalk& walk, auto&& fn) {
    int k = k0;
    for (; k + kSlabUnroll <= k1; k += kSlabUnroll) {
      uint4 u[kSlabUnroll];
#pragma unroll
      for (int i = 0; i < kSlabUnroll; ++i) {
        const int j = tid + (k + i) * kSlabThreads;
        u[i] = j < resident ? part[j] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kSlabUnroll; ++i, walk.next()) {
        const int j = tid + (k + i) * kSlabThreads;
        if (j < resident) fn(u[i], j, walk.ch);
      }
    }
    for (; k < k1; ++k, walk.next()) {
      const int j = tid + k * kSlabThreads;
      if (j < resident) fn(part[j], j, walk.ch);
    }
  };
  // 3. each stage as it lands; a thread reads only what it copied itself
  {
    ChannelWalk walk(v0 + tid, kSlabThreads, vpc);
#pragma unroll
    for (int s = 0; s < kSlabStages; ++s) {
      cp_async_wait(kSlabStages - 1 - s);
      each_resident(steps * s / kSlabStages, steps * (s + 1) / kSlabStages, walk,
                    [&](const uint4& u, int, int ch) { add(u, ch); });
    }
  }

  // 4. the CTA's moments (warps in order), then the cluster's, in rank order
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (tid == 0) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int w = 0; w < kSlabThreads / 32; ++w) {
      ts += red[0][w];
      tq += red[1][w];
    }
    cta_moments = make_float2(ts, tq);
  }
  cluster.sync();  // every CTA's moments are written
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float2 m = *cluster.map_shared_rank(&cta_moments, r);
      s1 += m.x;
      s2 += m.y;
    }
    const float cnt = (float)cg * (float)hw;
    const float mean = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
    group_stats = make_float2(mean, rsqrtf(var + eps));
  }
  cluster_arrive();
  __syncthreads();

  // 5. normalize from shared memory (the resident part) and from device
  //    memory (the rest), 16-byte stores. ((v + p - mean) * rstd) * scale +
  //    bias is one FMA per value: v * a + o, a = rstd * scale, o = bias +
  //    (p - mean) * a, taken anew when the channel changes.
  const float mean = group_stats.x, rstd = group_stats.y;
  const float* sc = scale + (int64_t)b * affine_bstride + (int64_t)g * cg;
  const float* bi = bias + (int64_t)b * affine_bstride + (int64_t)g * cg;
  int cur = -1;
  float a = 0.f, o = 0.f;
  auto norm = [&](const uint4& u, int ch) {
    if (ch != cur) {
      cur = ch;
      a = rstd * __ldg(sc + ch);
      o = fmaf((pre_g ? __ldg(pre_g + ch) : 0.f) - mean, a, __ldg(bi + ch));
    }
    float f[kVec];
    unpack16<T>(u, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float v = fmaf(f[i], a, o);
      f[i] = silu ? __fdividef(v, 1.f + __expf(-v)) : v;
    }
    return pack16<T>(f);
  };
  {
    ChannelWalk walk(v0 + tid, kSlabThreads, vpc);
    each_resident(0, steps, walk, [&](const uint4& u, int j, int ch) { os[v0 + j] = norm(u, ch); });
  }
  each_beyond([&](const uint4& u, int j, int ch) { os[v0 + j] = norm(u, ch); });
  cluster_wait();
}

template <typename T>
cudaLaunchConfig_t slab_config(cudaLaunchAttribute* attr, int cs, int groups, int b, int smem,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, groups, b);
  cfg.blockDim = dim3(kSlabThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow kSlabBudget bytes of dynamic shared memory, prefer shared memory
// over L1, and write how many clusters of cs CTAs with `smem` bytes each the
// card can hold at once (0: such a cluster cannot be scheduled).
template <typename T>
cudaError_t slab_prepare(int cs, int smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(gn_slab_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSlabBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_slab_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = slab_config<T>(&attr, cs, 1, 1, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(clusters, gn_slab_kernel<T>, &cfg);
  }
  cudaGetLastError();  // the error is returned; leave none behind for a later check
  return err;
}

template <typename T>
cudaError_t launch_slab(const void* x, const float* scale, const float* bias, const float* pre,
                        void* out, int b, int c, int hw, int groups, int cs, int smem,
                        int affine_bstride, float eps, int silu, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = slab_config<T>(&attr, cs, groups, b, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_slab_kernel<T>, static_cast<const T*>(x), scale, bias, pre, static_cast<T*>(out),
      c, hw, c / groups, affine_bstride, smem / 16, eps, silu);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ------------------------------------------------------------- statistics

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

// The v1 route. dtype: 0 = float32, 1 = bfloat16. x and out: contiguous
// [B, C, HW]; scale/bias: fp32 [C] (affine_bstride 0) or [B, C]
// (affine_bstride C); pre: fp32 [B, C] or null; partial: fp32 scratch of
// 2 * B * C * ceil(HW / chunk) values. Two launches. Returns the first failing launch's
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

static bool slab_args_ok(int dtype, int c, int hw, int groups, int cs, int smem) {
  const int item = dtype == 0 ? 4 : 2;
  return (dtype == 0 || dtype == 1) && groups > 0 && c % groups == 0 && hw > 0 &&
         (int64_t)hw * item % kSlabRowBytes == 0 && (cs == 1 || cs == 2 || cs == 4 || cs == 8) &&
         smem >= 16 && smem % 16 == 0 && smem <= kSlabBudget;
}

// The slab route's set-up for (dtype, cs, smem), once per process before
// the first launch of that kind and outside any stream capture: the shared
// memory attributes, then the number of such clusters the card holds at
// once into *clusters (the caller raises on 0).
extern "C" int dtts_group_norm_slab_clusters(int dtype, int cs, int smem, int* clusters) {
  if (!slab_args_ok(dtype, 1, 8, 1, cs, smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 0 ? slab_prepare<float>(cs, smem, clusters)
                                     : slab_prepare<__nv_bfloat16>(cs, smem, clusters));
}

// The slab route, one launch. Arguments as for dtts_group_norm, without the
// scratch; cs: CTAs per (batch, group) cluster (1, 2, 4 or 8); smem: dynamic
// shared bytes per CTA, a multiple of 16, at most kSlabBudget. x and
// out must be 16-byte aligned and HW * sizeof(dtype) a multiple of 16.
extern "C" int dtts_group_norm_slab(const void* x, const float* scale, const float* bias,
                                    const float* pre, void* out, int dtype, int b, int c, int hw,
                                    int groups, int cs, int smem, int affine_bstride, float eps,
                                    int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!slab_args_ok(dtype, c, hw, groups, cs, smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_slab<float>(x, scale, bias, pre, out, b, c, hw, groups, cs, smem,
                              affine_bstride, eps, silu, s);
  return launch_slab<__nv_bfloat16>(x, scale, bias, pre, out, b, c, hw, groups, cs, smem,
                                    affine_bstride, eps, silu, s);
}
