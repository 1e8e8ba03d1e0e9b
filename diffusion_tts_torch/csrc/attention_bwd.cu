// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU backward of diffusion_tts_tpu/ops/pallas/attention.py::
// _flash_attention_vjp (_attn_stats_kernel, _attn_bwd_dq_kernel,
// _attn_bwd_dkv_kernel), which both the qkv and the [B, T, H, D] custom VJPs
// route to. Same function (attention.py::_attention_bwd_explicit): with
// S = q.k^T * scale and P = softmax(S) in fp32,
//   delta_i = sum_d g_i o_i            (fp32, computed by the caller)
//   dV = P^T . g                       (P cast to the input dtype)
//   dP = g . v^T
//   dS = P * (dP - delta)              (fp32, then cast to the input dtype)
//   dQ = dS . k * scale,   dK = dS^T . q * scale
// every product accumulated in fp32, the scale applied after accumulation,
// results cast to the input dtype.
//
// What bounds it on this card: at least five T x T x d products (S, dP, dV,
// dQ, dK), 10*B*H*T^2*d operations, against 8 [B, T, H, d] tensors of
// traffic: bound by operations at T = 1024 and by bytes at T = 256 and 64.
// This first version runs the products on the CUDA cores (fp32 FMA from
// shared memory, as the forward kernel does), far below the tensor-core
// roof; mma/wgmma come later.
//
// What the design does about it:
//   * Nothing of the TPU design carries over. There a statistics kernel
//     recomputes each row's log-sum-exp (one more q.k^T pass) because the
//     TPU forward does not save it, and the statistics travel in [BH, T, 8]
//     and [BH, 8, T] layouts that answer Mosaic's tiling rules. Here the
//     forward kernel (csrc/qkv_attention.cu) writes the row statistic it
//     already holds, as fp32 [B, H, T] in the log2 domain, and P is
//     recomputed as exp2(s * scale * log2e - lse): no [T, T] tensor ever
//     reaches device memory.
//   * dQ sums over key tiles and dK/dV sum over query tiles. One fused
//     kernel would need fp32 atomics for one of them, and gradients would
//     then differ from run to run. Two kernels instead, each owning its
//     results: dq_kernel, one block per (batch, head, 64-row q tile), streams
//     K/V tiles; dkv_kernel, one block per (batch, head, 64-key tile), streams
//     Q/g tiles. S and dP are computed by both (16*B*H*T^2*d operations
//     instead of 10). No atomics: the results are bit-identical from run to
//     run.
//   * 256 threads as 16 x 16, as in the forward: each thread owns 4 x 4 of
//     the S / dP tile (both products share one pass over d: four operand
//     loads feed 32 FMAs) and 4 x DP/16 of each result. dS (and P^T for dV)
//     go through shared memory in the input dtype's rounding; rows are padded
//     by one float against bank conflicts.
//   * Explicit (batch, token, head) strides for q/k/v, for g and for the
//     results: the qkv form reads q, k and v as the thirds of [B, T, 3C] and
//     writes dq | dk | dv straight into the thirds of one [B, T, 3C] gradient,
//     with no head-split copy and no concatenation.
//   * Head widths 4 ... 160 (the forward's, padded to 16 with zero columns);
//     at d = 512 four fp32 operand tiles exceed a block's shared memory, and
//     the wrapper raises.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // q rows and keys per tile
constexpr int kPer = kTile / 16;     // rows / keys per thread
constexpr int kSPitch = kTile + 1;   // dS / P smem row (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A value in the input dtype's rounding, for a product's operand.
template <typename T> __device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

template <int D>
struct Shape {
  static constexpr int kDP = (D + 15) / 16 * 16;  // D padded with zero columns
  static constexpr int kCols = kDP / 16;          // result columns per thread
  static constexpr int kPitch = kDP + 1;          // operand smem row (floats)
  static constexpr int kOperand = kTile * kPitch; // floats of one operand tile
  static constexpr int kDqSmem = (4 * kOperand + kTile * kSPitch) * (int)sizeof(float);
  static constexpr int kDkvSmem =
      (4 * kOperand + 2 * kTile * kSPitch + 2 * kTile) * (int)sizeof(float);
  static_assert(kDkvSmem <= 232448, "tiles exceed a block's shared memory");
};

// Load one [kTile, DP] tile (rows row0.., clipped at t; columns past D are
// zero) into padded smem.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0, int t,
                                          int64_t stride_t, int tid) {
  constexpr int DP = Shape<D>::kDP;
  for (int e = tid; e < kTile * DP; e += kThreads) {
    int r = e / DP, c = e % DP;
    int row = row0 + r;
    dst[r * Shape<D>::kPitch + c] = (row < t && c < D) ? to_f32(base[row * stride_t + c]) : 0.f;
  }
}

// a[i][j] = sum_d x[ty + 16 i][d] * y[tx + 16 j][d] and the same for (u, w),
// in one pass over d.
template <int D>
__device__ __forceinline__ void two_products(const float* x, const float* y, const float* u,
                                             const float* w, int ty, int tx,
                                             float (&a)[kPer][kPer], float (&c)[kPer][kPer]) {
  using S = Shape<D>;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < S::kDP; ++d) {
    float xv[kPer], yv[kPer], uv[kPer], wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      xv[i] = x[(ty + 16 * i) * S::kPitch + d];
      uv[i] = u[(ty + 16 * i) * S::kPitch + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      yv[j] = y[(tx + 16 * j) * S::kPitch + d];
      wv[j] = w[(tx + 16 * j) * S::kPitch + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
        c[i][j] = fmaf(uv[i], wv[j], c[i][j]);
      }
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] * x[r][tx + 16 j] over the tile's rows r.
template <int D>
__device__ __forceinline__ void accumulate(const float* p, const float* x, int ty, int tx,
                                           float (&acc)[kPer][Shape<D>::kCols]) {
  using S = Shape<D>;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float pv[kPer], xv[S::kCols];
#pragma unroll
    for (int i = 0; i < kPer; ++i) pv[i] = p[(ty + 16 * i) * kSPitch + r];
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) xv[j] = x[r * S::kPitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kCols; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
  }
}

// Store acc * scale for rows row0 + ty + 16 i < t, columns tx + 16 j < D.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[kPer][Shape<D>::kCols],
                                           float scale, int row0, int t, int64_t stride_t,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int row = row0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < Shape<D>::kCols; ++j) {
      int col = tx + 16 * j;
      if (col < D) base[row * stride_t + col] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// dQ: one block per (batch, head, q tile); K/V tiles stream.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ g, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t,
          int64_t in_sb, int64_t in_st, int64_t in_sh,
          int64_t g_sb, int64_t g_st, int64_t g_sh,
          int64_t out_sb, int64_t out_st, int64_t out_sh,
          float scale_log2e, float scale) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [kTile][kPitch]
  float* gs = qs + S::kOperand;
  float* ks = gs + S::kOperand;
  float* vs = ks + S::kOperand;
  float* ds = vs + S::kOperand;     // [kTile][kSPitch]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
  load_tile<T, D>(gs, g + blockIdx.z * g_sb + blockIdx.y * g_sh, q0, t, g_st, tid);

  float row_lse[kPer], row_delta[kPer], acc[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int row = q0 + ty + 16 * i;
    row_lse[i] = row < t ? lse[stat_off + row] : 0.f;
    row_delta[i] = row < t ? delta[stat_off + row] : 0.f;
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kTile) {
    load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
    load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    two_products<D>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float p = (k0 + tx + 16 * j < t) ? exp2f(s[i][j] * scale_log2e - row_lse[i]) : 0.f;
        ds[(ty + 16 * i) * kSPitch + tx + 16 * j] = round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncthreads();
    accumulate<D>(ds, ks, ty, tx, acc);
    __syncthreads();  // dS, K and V are read: the next tile may overwrite them
  }
  store_rows<T, D>(dq + blockIdx.z * out_sb + blockIdx.y * out_sh, acc, scale, q0, t, out_st,
                   ty, tx);
}

// dK and dV: one block per (batch, head, key tile); Q/g tiles stream. The
// score tile is held transposed, [key][q], so that each thread's result rows
// are its keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t,
           int64_t in_sb, int64_t in_st, int64_t in_sh,
           int64_t g_sb, int64_t g_st, int64_t g_sh,
           int64_t out_sb, int64_t out_st, int64_t out_sh,
           float scale_log2e, float scale) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][kPitch]
  float* vs = ks + S::kOperand;
  float* qs = vs + S::kOperand;
  float* gs = qs + S::kOperand;
  float* pt = gs + S::kOperand;     // [kTile][kSPitch]: P^T in the input dtype's rounding
  float* dst = pt + kTile * kSPitch;  // [kTile][kSPitch]: dS^T likewise
  float* lse_s = dst + kTile * kSPitch;  // [kTile]
  float* delta_s = lse_s + kTile;        // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t g_off = blockIdx.z * g_sb + blockIdx.y * g_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
  load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);

  float acc_k[kPer][S::kCols], acc_v[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kTile) {
    load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
    load_tile<T, D>(gs, g + g_off, q0, t, g_st, tid);
    if (tid < kTile) {
      // a q row past the end gets lse = +inf, so its P and dS are 0
      int row = q0 + tid;
      lse_s[tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[tid] = row < t ? delta[stat_off + row] : 0.f;
    }
    __syncthreads();

    float st[kPer][kPer], dpt[kPer][kPer];  // [key][q]
    two_products<D>(ks, qs, vs, gs, ty, tx, st, dpt);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int col = tx + 16 * j;
        float p = exp2f(st[i][j] * scale_log2e - lse_s[col]);
        pt[(ty + 16 * i) * kSPitch + col] = round_to<T>(p);
        dst[(ty + 16 * i) * kSPitch + col] = round_to<T>(p * (dpt[i][j] - delta_s[col]));
      }
    __syncthreads();
    accumulate<D>(pt, gs, ty, tx, acc_v);
    accumulate<D>(dst, qs, ty, tx, acc_k);
    __syncthreads();  // the tiles are read: the next q tile may overwrite them
  }
  const int64_t out_off = blockIdx.z * out_sb + blockIdx.y * out_sh;
  store_rows<T, D>(dk + out_off, acc_k, scale, k0, t, out_st, ty, tx);
  store_rows<T, D>(dv + out_off, acc_v, 1.f, k0, t, out_st, ty, tx);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int b,
                   int h, int t, const int64_t* in_s, const int64_t* g_s, const int64_t* out_s,
                   float scale_log2e, float scale, cudaStream_t stream) {
  using S = Shape<D>;
  // Both kernels' tiles are above the 48 KB default; the attribute is per
  // device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kDkvSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, h, b);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *gp = static_cast<const T*>(g);
  dq_kernel<T, D><<<grid, kThreads, S::kDqSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), t, in_s[0], in_s[1], in_s[2], g_s[0],
      g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<T, D><<<grid, kThreads, S::kDkvSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t, in_s[0], in_s[1],
      in_s[2], g_s[0], g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16, 32,
// 40, 64, 80, 160. lse and delta are fp32 [B, H, T]: the forward kernel's row
// log2-sum-exp2 and sum_d g*o. Strides are in elements for (batch, token,
// head), the head width's stride being 1: one triple for q, k and v, one for
// g, one for dq, dk and dv. Two launches (dQ, then dK/dV). Returns the first
// failing launch's cudaError_t (0 on success); the caller raises on anything
// else.
extern "C" int dtts_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const float* lse, const float* delta, void* dq, void* dk,
                                  void* dv, int dtype, int d, int b, int h, int t,
                                  int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t g_sb,
                                  int64_t g_st, int64_t g_sh, int64_t out_sb, int64_t out_st,
                                  int64_t out_sh, float scale_log2e, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t in_s[3] = {in_sb, in_st, in_sh}, g_s[3] = {g_sb, g_st, g_sh},
                out_s[3] = {out_sb, out_st, out_sh};
#define DTTS_ATTN_BWD(D)                                                                      \
  case D:                                                                                     \
    if (dtype == 0)                                                                           \
      return launch<float, D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, out_s,  \
                              scale_log2e, scale, s);                                         \
    if (dtype == 1)                                                                           \
      return launch<__nv_bfloat16, D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s,      \
                                      g_s, out_s, scale_log2e, scale, s);                     \
    break;
  switch (d) {
    DTTS_ATTN_BWD(4)
    DTTS_ATTN_BWD(8)
    DTTS_ATTN_BWD(16)
    DTTS_ATTN_BWD(32)
    DTTS_ATTN_BWD(40)
    DTTS_ATTN_BWD(64)
    DTTS_ATTN_BWD(80)
    DTTS_ATTN_BWD(160)
  }
#undef DTTS_ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
